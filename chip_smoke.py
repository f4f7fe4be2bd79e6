#!/usr/bin/env python3
"""Drive the PyTorch port (rakau_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py [--n N] [--seed S] [--phases GROUP,...]

--phases runs only the named groups of PHASES (device among them; e.g.
device,build,multicard on a machine with several cards); every group runs
by default, and only then is the kernels line printed.

Phases, each printing one JSON line:
  1. device:   the card (nvidia-smi name and power limit), torch and CUDA;
  2. build:    nvcc builds the five kernel libraries from csrc/ and the
               float64 builds of three (shared_fused, pool, tiles) at
               once, one process each (timed; ptxas registers and spills);
  3. edge:     kernel vs plain PyTorch on small random cases in every form
               (K1a monopole, K1b compensated, K1d quadrupole, K1d with
               K1b's sums) and mode (self pairs, far padding, an empty
               tile, ragged T and S, a masked-out node row on top of a
               target), and on rows made for K1's plan (k1_structure_cases:
               a list of every granule beside a tile with none, scattered
               live granules, lists not a multiple of the span, S ending
               inside a granule that is a tile's only live one; two
               launches bit for bit equal; the same in the cell forms and
               in float64); on a long cancellation-heavy row the compensated
               kernel's error against a float64 sum must be < the fp32
               kernel's (equal errors would mean fp32 sums); then the same
               for the pool kernel K2 (edge_pool): every form and mode on
               synthetic pools with self pairs, a node row on top of a
               target at eps = 0, an empty tile, tiles in two windows,
               ragged T, pool_block 128, 512 and 200 (ragged granules), a
               segment far longer than the rest, padding at 4 * box and at
               1e30, 2-D operands (the plan K2's kernel builds equal to
               pool_plan's, two launches bit for bit equal), and a
               cancellation-heavy segment; then the cell-separation forms
               K1c (edge_cell):
               every form and mode with random leaf cells on both sides
               of grid_sep 2 and 3, exempt rows (cell -1), self pairs that
               are covered too, ragged T and S, an empty tile and, in the
               quadrupole forms, the masked-out node on a target; then the
               tensor-core form K6 (edge_mma: every mode and precision,
               with and without the cell test: a source exactly on a
               target, an all-masked tile, a ragged last block, S < 128, a
               tile whose only active block is the last, exempt cells; and
               on rows made for its plan, K1's (k6_structure_cases), with
               no cells, 3-D cells and 2-D cells on 2-D operands: a long
               list beside a tile with none, scattered granules, lists not
               a multiple of the span, S ending inside a granule, padding
               at 1e30 and at 4 * box; the plan K6's kernels build equal
               to fused_plan's, two launches bit for bit equal) and
               the block-plan form K5 (edge_blocks: the same rows and
               rows made for its plan at blocks of 1024, a long list
               beside empty tiles, a tile's blocks all at the row's end,
               S ending inside a block, lists not a multiple of the span,
               self pairs, eps 0 and 0.01, at spans 1, 2 and BLOCKS_SPAN;
               the plan K5's kernels build equal to fused_plan(mask, span,
               BLOCK), two launches bit for bit equal); the
               float64 builds (edge_f64: every K1 form, K1c and K2 form
               and mode against the float64 plain versions at rtol 1e-9,
               and the staircase() check of the compensated forms); and
               the tile kernels K3 and K4 in float32 and float64
               (edge_tiles: counts of 0, of the whole row and not multiples
               of the granule or the block, self pairs, a node on a target
               at eps = 0, eps 0 and 0.05, ragged T, padding at 1e30 and at
               4 * box, a 2-D case; K3 against K4, K3 and K4
               bit-repeatable, the plan K3's kernel builds equal to
               tiles_plan's; K4 one row a launch, M2P without and P2P
               with indices, blocks of 64, 200 and 1024, counts past S,
               negative, 0 and short of the live entries, its card plan
               equal to pairwise_plan's: k4_row_cases);
  4. main:     a Plummer sphere of N particles (default 1,048,576) from a
               seeded CUDA generator, octree(...) with the headline
               shared+grid configuration, accs_pots_o(theta=0.75) once
               cold and three times warm (median and spread reported);
               the kernel's launches in a warm query must equal the
               number of chunks it evaluated. Launch counts are measured:
               the wrappers count where they launch (eagerly, in a warm-up
               or a capture), a replay calls none, so a replayed query's
               launches are its main kernels' records in the card's
               profile (profile_launches, measured), held to the
               bookkeeping of the wrappers and the graphs' replays
               (counted); every count the kernels line states is one;
     sweep:    the same tree at theta 0.6, then eps 1e-3, then G 0.5:
               each a graph input, so no call captures and each changes
               the sums (scalar_sweep);
  5. layers:   one more warm query with the walk, the walk + far field and
               the kernel call each timed between device syncs (run
               eagerly, engine.acc_pot_u_host(graph=False), as every
               *_layers phase below: a graph replay would skip the timed
               functions and a capture refuses a sync);
  6. profile:  one more warm query under torch.profiler (CUDA activity
               only): device ops, device-busy ms (union of the device
               intervals), the kernel's device ms and the idle share;
     graphs:   the query replayed from its CUDA graphs (the default on
               the card) against the same query run eagerly (graph=False)
               on one tree (shared+grid and lists: their configurations
               on SMALL_N particles): the graph cache
               emptied, the first graphed query's seconds (warm-up,
               capture, replay), GRAPH_REPS warm queries each way in
               turns (median, spread, peak memory, launches = chunk
               evaluations on both), a profile each way
               (whose records show them),
               the graph pool's memory; the sums bit for bit equal, flags
               and maxima equal (graph_ab; likewise after lmac_profile,
               gwalk_profile and lists_profile); then engine.acc_pot_u,
               the whole query as one graph, on a tree of 131,072
               Plummer particles (SMALL_N), against the eager query:
               equal sums, K1a launches = the tile capacity's chunks
               (acc_pot_u_check); the tree build replayed from its graph
               (engine.build_tree) against the eager build on the main
               particles, every TreeData field equal, first call's
               seconds, warm ms each way (build_ab); a Tree rebuild at
               the same N twice, the second capturing nothing
               (rebuild_captures); the graft entry's counterpart,
               integrate.acc_pot as one graph on __graft_entry__.py's
               configuration (16,384 Plummer particles, caps grown
               through the Tree first), force RMS < 5e-3, K1a launches =
               the tile capacity's chunks, bit-equal to and timed against
               integrate.acc_pot_host, with its build graphed against
               eager (graft_entry); acc_pot and leapfrog_step_morton there
               on builds overflowed at node_cap 4 and tile_cap 4 raising
               RuntimeError after the replay, the normal calls then
               replaying unchanged (overflow_refused); after the
               leapfrog's steps config #2's step three ways on a cold
               sphere of 131,072 particles (SMALL_N) with the 1M
               caps, the whole
               integrate.leapfrog_step_morton as one graph, the sliced
               leapfrog_step_morton_host and the same eagerly, pos, vel
               and step_perm bit-equal, the whole step's capture seconds
               and memory, K1a launches of a replay measured: 2 x the
               tile capacity's chunks whole, 2 x the chunk evaluations
               sliced, a whole step at -dt capturing nothing and equal
               to the sliced one (step_three_ways); total_energy as one
               graph against total_energy_host on that sphere, within 1
               ulp, K1d+K1b and K1b
               launches measured (energy_two_ways), with config #2's
               build graphed against eager (build_ab, at the start of
               phase leapfrog); and a closing summary line after phase
               10;
  7. kernel:   kernel vs plain PyTorch on the first two chunks of that
               query (the same targets, shared sources and masks), every
               mode, rtol 2e-4 and atol 2e-5*max|plain|, both timed, with
               K1's launch shape (granules, spans, work items, CUDA
               blocks, warps a SM: k1_shape) and its share of the bound,
               as every K1 kernel phase below prints them;
  8. accuracy: 256 sampled targets against the float64 direct sum, run
               on the card (card_oracle) and held on 8 of them to the
               NumPy one, direct_acc_pot_np, within 1e-12 (as every
               oracle from 262,144 particles up): RMS relative force
               error < 5e-3, potential < 2e-3;
  v. variants: the query of SMALL_N particles (TREE_KW) whole under
               dispatch.shared_variant: "mma"
               at bf16, x3 and highest, and "blocks": launches of the
               variant = chunks and no K1a launch; x3, highest and K5
               within 1 % of K1a's force RMS and under the bounds, one bf16
               pass under 5e-2 (see BF16_FORCE_RMS_MAX); each variant's
               kernel call (between device syncs) beside K1a's;
     variant_launches: the main query's tree once eagerly under each
               variant: its launches = chunks and no other kernel's, the
               count of its row in the kernels line, beside the times the
               kernel phase takes on the same tree;
     kernel:   K6 (each precision and mode) and K5 against their plain
               versions on the first two chunks, timed beside K1a on the
               same rows, with bounds and % of them; K6's launch shape
               (k6_shape) beside K1a's; K5's launch shape (k5_shape) and
               its card plan equal to fused_plan's at blocks of 1024;
     metrics:  metrics.collect_shared_density on the query; its processed
               pairs must equal what K1's plan (shared.fused_plan: active
               granules) gives for the same chunks, which K6's kernels
               must build too, and which the "mma" variant replays; K5's
               kernels' plan at blocks of 1024 likewise, for "blocks";
  s. grid2:    the same particles through the shared traversal with
               farfield "grid2" (local_order 4, grid_sep 3, the level from
               grid_occupancy 32: 5 at 1M), caps grown by the Tree and
               fitted by tune_caps; once cold, three times warm: K1c
               (mono_cell) launches per warm query = chunks and no other K1
               form, finite results, force RMS < 5e-3, potential < 2e-3;
               then local_order 6 with the quadrupole and compensated sums
               (quad_comp_cell and mono_comp_cell launches = chunks each),
               whose force RMS must be below the order-4 monopole's, and
               the same with fp32 sums (quad_cell);
     grid2_layers: a warm query split between device syncs (walk, kernel
               call, L2P, rest) and the leaf locals a tree keeps: pyramid,
               M2L kernels and convolutions per level (the port's form and
               the same through cuDNN), L2L chain;
     grid2_tf32: order 6, grid2.far_field in float32 against the same in
               float64 on the card, with both global TF32 switches turned
               ON for the duration: relative difference < 1e-4 of the
               field's maximum, which holds only because grid2 guards its
               own convolutions and products;
     kernel:   K1c against plain PyTorch on the first two chunks of the
               grid2 query (mono_cell, every mode) and on the first chunk
               of the quadrupole + compensated one (quad_comp_cell and
               quad_cell on node rows, mono_comp_cell on particle rows);
  l. lmac_cpu_cuda: a 65,536-particle tree: the slice's candidate table
               and chunk 0's sources from traversal3 on the card and on the
               CPU, every field exactly equal;
     lmac:     the same particles through the reference's lmac1m
               configuration (the lmac1m stage of the reference's stage
               list under benchmarks/, on bench.py:54-78: lmac + grid2
               order 4 / sep 2, caps 9728 / 5888 / 47104, frontier_cap
               65536 for the slice's candidate table), caps grown by the
               Tree and fitted by tune_caps; once cold, three times warm:
               K1c launches = chunks and no other form, the group table's
               rows (maxima slot 2) above 0 and under their cap, force RMS
               < 5e-3, potential < 2e-3, and force RMS at most 1.1 x the
               shared engine's with the same far field, level and theta;
               then lmac_layers (group pre-filter, predicate and
               materialisation, kernel call, L2P, rest between device
               syncs), lmac_profile (as phase 6), variants ("mma" at each
               precision: mma_cell launches = chunks), kernel (K6 with the
               cell test beside K1c) and metrics (density);
     lmac_gate: the reference's accuracy gate at 65,536 particles (lmac +
               grid2 order 6 / sep 3, quadrupole, compensated, theta 0.5):
               force RMS <= 2e-4; quad_comp_cell and mono_comp_cell
               launches = chunks each;
     metrics:  metrics.measure_kernel_roof at 262,144 sources, pairs/s:
               K1a, K1c, K6 x3 (with and without cells), K5;
  g. gwalk:    the same particles through bench.py's gwalk configuration
               (bench.py:47-85 and 103-140: global caps 3n/n/16n/n//4,
               tile_cap fitted to the built tiles, caps and per-round
               caps from engine.tune_gwalk), accs_pots_o(theta=0.75) once
               cold and three times warm: one K2 launch per warm query and
               no K1 launch, sampled force RMS < 5e-3 and potential
               < 2e-3 (the shared query's beside them); then gwalk_layers
               (walk, pool build, K2 call, far field, each between device
               syncs) and gwalk_profile (as phase 6);
     gwalk_quad: the same particles with farfield "m2p": monopole fp32,
               then quadrupole + compensated sums (pool_window 131072),
               each tuned by tune_gwalk, plus the monopole compensated and
               quadrupole fp32 forms on those configurations: one launch
               of each K2 form, quadrupole force RMS < 0.6 x monopole's,
               and both force RMS within 1 % of the shared engine's on
               the same particles (see QUAD_RMS_RATIO);
     kernel:   K2 against plain PyTorch on the real pools: monopole on the
               gwalk+grid query's, every form on the quadrupole query's;
               mode "both" on every tile (plain run in groups of tiles),
               "acc" and "pot" on a stated subset; rtol 2e-4 and atol
               2e-5*max|plain|, both timed; two launches bit for bit
               equal, the card's plan equal to pool_plan's; segment
               lengths and the launch shape (granules, spans, work items,
               CUDA blocks, warps a SM, registers: pool_shape) reported;
     gwalk_grid2: gwalk with farfield "grid2" (local_order 4, grid_sep 3,
               tiles clipped at its level, sized as phase g): one K2 launch
               per warm query and no K1 launch, force RMS < 5e-3, potential
               < 2e-3 and within 1 % of the shared engine's with grid2 at
               gwalk's grid level (3 at 1M; the shared run's own level is
               5 and its error lower, reported beside it: the reference
               holds the two within 15 % at one set level,
               tests/test_gwalk.py:78-99); then the
               quadrupole (pool_window 131072): force RMS < 0.6 x the
               monopole's;
  t. lists:    the same particles through the lists path (per-tile
               interaction lists, traversal.py, and K3; farfield "m2p",
               the caps of TREE_KW grown by the Tree), once cold and three
               times warm: K3 launches per warm query = chunks and no
               other launch, force RMS < 5e-3 and potential < 2e-3 beside
               the shared engine's; lists_layers (walk, gather, kernel
               call, rest between device syncs), lists_profile (as phase
               6), lists_split (the whole query on K4: 2 launches a chunk,
               force RMS within 1 % of K3's), kernel (K3 and K4 against
               their plain versions on chunks 0 and 1, each bit-repeatable,
               K3's plan equal to tiles_plan's and K4's to pairwise_plan's,
               with the CUDA blocks against the SMs and their launch
               shapes: tiles_shape, pairwise_shape);
     lists_quad: 262,144 particles: the lists monopole (K3), the
               quadrupole with farfield "local" on the lists path (the
               reference's plain-op route, no kernel: xla_quad = chunks),
               and shared+m2p with the quadrupole (K1d, K1a): the lists
               quadrupole's force RMS below the lists monopole's and
               within 10 % of the shared quadrupole's;
     f1:       65,536 particles: a quadtree (2-D, shared, theta 0.5: K1a
               launches all "d2", force and potential RMS < 2e-2) and a
               float64 octree from NumPy float64 arrays (theta 0.4: K1a
               "f64", force RMS < 2e-3), the same float64 particles
               through gwalk (K2 "f64") and the lists path (K3 "f64",
               then under tiles_variant("split") K4 "f64"), each with
               every plain version made to raise; the float64 kernels
               against their plain versions on chunk 0;
     multi:    the multi-device paths, every shard of a mesh on
               cuda:(r % card count) (with one card all share it, and no
               copy between cards or NVLink collective is made): F2, on
               65,536 Plummer particles (shared+grid), the query under
               kernel_backend="xla" makes no hand launch and agrees with
               "auto" to 1e-5 force RMS, and "pallas" on a CPU copy of the
               tree raises; parallel.sharded's _host twins on 131,072
               Plummer particles (SMALL_N; the main caps) at 1, 2 and 4
               shards against the
               single-device query with farfield "local" (rtol 1e-5, atol
               1e-6 of the largest; K1a launches summed over the shards =
               chunks; seconds a query), then one
               leapfrog_step_sharded_host at 4 shards against
               integrate.leapfrog_step_host (pos within 1e-6, vel within
               1e-5 of their largest); the whole twins beside them, each
               call one CUDA graph: acc_pot_u_sharded at 2 and 4 shards
               (its first call; 3 warm calls each way in turns with the
               _host twin, capturing nothing; K1a launches of a replay on
               the card's profile = the capacity chunks padded to a
               multiple of the shards; sums bit-equal to the _host twin's
               and to engine.acc_pot_u's; at 1 shard, where its graph
               would be engine.acc_pot_u's, the body once eagerly, the
               same equalities), leapfrog_step_sharded at 4 shards
               against leapfrog_step_sharded_host (first call, 3 warm
               steps each way in turns, none capturing; 2 x the padded
               chunks of K1a by bookkeeping) and integrate.leapfrog_step
               run eagerly (pos and vel bit-equal, else where they part
               is named and the step tolerances hold); parallel.let's
               _host twin on min(65,536, --n) Plummer particles, 4 shards,
               shared+"local", theta 0.75, eps 0.01, distributed phase 0,
               the export caps raised until export_ovf is clear (printed):
               force RMS against the float64 direct sum below max(1.5 x
               the single-device query's, 2e-3), potential RMS < 5e-3,
               phase0="global" within 3e-3 RMS of it, the [4, 4] export
               counts, the halo bytes, the seconds of the query and of
               each stage; the whole acc_pot_let beside it in both phase0
               modes (first call, 2 warm calls each way in turns, none
               capturing; sums, flags and export counts bit-equal to the
               _host twin's; its force RMS); and the accuracy engine (lmac
               + "m2p" + quadrupole, 65,536 particles, 4 shards) within
               5e-3 of its single-device query (max |difference| over max
               |acc|);
     multicard: the staged pipelines that the whole twins run on a mesh
               over several cards (parallel/mesh.py: a CUDA graph a card
               and stage, the copies between cards between them), first
               on one card: sharded._query_impl(staged=True) at 4 shards
               on a tree of 131,072 Plummer particles (SMALL_N; the
               main caps grown with "local") and
               let._let(staged=True) at 65,536 particles in both phase0
               modes, each against the same whole twin as one graph on
               the same one-card mesh: first call of each, 3 warm calls
               each way in turns (none capturing), one profiled staged
               call (K1a a card from the profile's device index, summing
               to the padded capacity chunks for the query; busy share a
               card), bit-equal sums, flags and export counts; then, with
               more than one card, on default_mesh() and
               default_mesh(2 x cards), each whole twin across the cards
               against the same call on a one-card mesh of as many
               shards, with its _host twin and graph=False across the
               cards held equal too: the sharded query on the main tree
               (and, on default_mesh() only, on cards x N particles), the
               sharded step and acc_pot_sharded on the main particles,
               the LET at 262,144 in both phase0 modes and the accuracy
               engine's LET at 65,536, each case on a line of its own
               (multicard_case); with the bytes copied between cards, the
               peer
               access of each pair, and each graph's tensors on its
               key's card;
  9. leapfrog: BASELINE config #2 (benchmarks/configs.py:90-114) through
               rakau_tpu_torch.integrate: a cold sphere of N particles
               (--n, default 1,048,576), zero velocities, 3 steps of
               leapfrog_step_morton_host_safe at theta=0.75 (farfield
               "local"; the third, with no cap grown, and the energy
               queries after the first capture no graph), energies E0
               and E3 from total_energy_host with the quadrupole +
               compensated m2p configuration at theta=0.25, its caps sized
               first through the Tree API's grow-and-retry. Checks: finite
               results, drift |E3 - E0| / |E0| < 2e-3, K1d+K1b and K1b
               launches each equal to the energy query's chunks, sampled
               force RMS < 1.5e-2 (the top of the reference's own error
               there) and potential RMS < 2e-3 of the step configuration,
               potential RMS < 1e-4 of the energy configuration; the same
               query with fp32 sums (K1d) is reported beside it;
 10. kernel:   K1d+K1b on the node rows [0, U) and K1b on the particle
               rows [U, S) of the energy query's first chunk (and K1d on
               the node rows) against plain PyTorch, every mode, timed.
     scale:    the reference's own sizes on one card (the graphs of the
               groups before released first): 8,000,000 Plummer particles
               (bench.py's headline) through octree(..., shared+grid
               caps).accs_pots_o(0.75) (build, first query, 3 graphed
               warm queries, K1a launches a warm query = the chunk
               evaluations, grid level, tiles, chunks, peak memory), the
               same particles through bench.py's gwalk+grid recipe (one
               K2 launch a warm query; the pool's rows), both against a
               float64 direct sum on the card at 256 targets (held to
               direct_acc_pot_np on 8 of them): force RMS < 5e-3,
               potential < 2e-3, gwalk's force RMS at most 1.01 x
               shared's; K1a against its plain version on the first and
               last live chunk, K2 on 128 tiles about a window boundary;
               then BASELINE config #2 at 1 << 23 particles: the energy
               configuration's caps sized through the Tree, E0, 2 steps
               of leapfrog_step_morton_host_safe (cap retries reported),
               the first step's query on the initial state (force RMS <
               1.5e-2, potential < 2e-3), E after the steps (drift <
               2e-3; energy potential RMS < 1e-4), K1d+K1b against its
               plain version on the energy tree's first chunk.
     configs:  BASELINE configs #0, #1, #3 and #4 (benchmarks/configs.py)
               at the reference's own sizes on one card, every earlier
               graph released first, each configuration's caps grown
               where its query flags them (reported): #0, 16,384
               Plummer particles through engine.build_tree and the whole
               engine.acc_pot_u against direct_acc_pot_np at every
               target (force RMS < 5e-3, potential < 2e-3); #1, a 1M
               uniform cube through the whole integrate.acc_pot at eps 0,
               1e-3 and 1e-2 (theta, eps and G are graph inputs: the 2nd
               and 3rd softening capture nothing; each bit-equal to
               graph=False; < 1.5e-2 / 2e-3 at 256 targets); #3, 1 << 26
               disk particles, compensated: build, rebuild of the drifted
               Morton-ordered positions (a replay), engine.acc_pot_u_host
               first and warm (K1b launches = its chunk evaluations;
               force and potential RMS under 1.1 x the reference's own
               error extrapolated to 1 << 26, disk_bound), K1b against
               its plain version on the first and last
               live chunk; #4, 1 << 23 cube particles through
               sharded.acc_pot_sharded_host on a one-card mesh of one
               shard, bit-equal to integrate.acc_pot_host, K1a against its
               plain version at those shapes (build ms, first call s, warm
               ms, evals/s, peak MB, caps grown, RMS, launches by form);
     accuracy: lmac+grid2, the reference's accuracy engine, at its own
               sizes on one card (every earlier graph released first):
               lmac8m, 8,388,608 Plummer particles through octree(...,
               LMAC_KW).accs_pots_o(0.75) (the Tree's cap growth,
               tune_caps, the tuned caps' first query, 3 graphed warm
               queries: K1c launches a warm query = the chunk
               evaluations; grid level 6, tiles, chunks, slices, caps,
               maxima and flags, peak memory; K1c against its plain
               version on the first and last live chunk; the leaf locals
               alone; the shared engine's first query on the same tree
               beside it), lmac8m_l7, the same tree at grid level 7
               through engine.acc_pot_u_host (the query state and the
               leaf locals alone, with their peak memory; first and 3
               warm queries), both against a float64 direct sum on the
               card at 256 targets: force RMS < 5e-3, potential < 2e-3,
               lmac8m's force RMS at most 1.1 x the shared engine's;
               then the accuracy ladder at 1,048,576 (benchmarks/
               ladder.py: rungs o4/s2 monopole, o6/s3 quadrupole, the
               same through the shared traversal, o8/s3 and o8/s4
               quadrupole with compensated sums; caps grown x4 on a flag
               at most 3 times, then one graphed warm query, each K1
               form once a chunk evaluation) against the float64 oracle
               at 2,048 targets, held to ladder_bounds; K1c+K1d (rung b)
               and K1c+K1d+K1b (rung d) against their plain versions on
               chunk 0. Every result finite, no flag left;
     ladder:   config #4 over four cards (only where there are four; a
               line says it skipped otherwise), a shard a card, every
               rung required (an out-of-memory error fails the run): the
               replicated path, sharded.acc_pot_sharded_host at 2^23 and
               2^24 particles a card (first call, caps grown, warm ms
               and its K1a by bookkeeping, at 2^23 K1a and busy ms a card
               from a profiled call, peak allocated and reserved MB,
               graph pools and pins a card, MB copied, RMS), at 2^23 the
               same call on one card (bit-equal, its peak beside card
               0's) and the whole staged sharded.acc_pot_sharded (first
               call with each card's capture seconds, pools and pins, a
               warm call and its K1a, bit-equal to the _host twin); then
               the LET, let.acc_pot_let_host (phase0 "distributed") at
               2^16 a card (export_cap sized from one call's counts,
               then confirmed; warm ms, K1a and busy ms a card, peaks,
               MB copied, the export matrix and halo bytes, the
               replicated _host twin on the same particles beside it:
               its card 0 peak and force RMS, the LET's at most
               LET_FORCE_RATIO x it), phase0 "global" within
               LET_CROSS_MAX and the whole staged let.acc_pot_let
               bit-equal (sums, flags, counts). Oracle at 256 targets on
               every rung (LF_FORCE_RMS_MAX, CUBE_POT_RMS_MAX).
               Each group ends with a line {"phase": "group", "group":
               ..., "seconds": ...}.
Then the whole command's seconds (phase total), the kernels' summary line
(time, plain time and bound of every form), the card line, and as the
last line {"ok": true, "device": {...}}. Any
failure raises (non-zero exit) before that line. Needs a CUDA card; JAX
is not used.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager

import numpy as np
import torch

# the phase groups that --phases selects, in the order they run (edge: the
# edge phases; main: phases main through f1)
PHASES = ("device", "build", "edge", "main", "multi", "multicard",
          "leapfrog", "scale", "configs", "accuracy", "ladder")
THETA = 0.75
# The checks whose point holds at any N (twins bit-equal to each other,
# launches = the chunks each way, nothing captured in a steady state)
# run on this many particles (at most --n) with the main run's caps, to
# keep the whole script inside its time limit beside phase scale: phase
# multi's sharded query and step and their whole twins (156 s of the
# limit at 1M), phase multicard's staged query on one card (the cards'
# own run keeps 1M), engine.acc_pot_u as one graph (45 s at 1M), and
# config #2's step three ways and energy two ways (150 s at 1M), and
# phase variants' whole queries on K6 and K5 (87 s at 1M); the main
# query, its graphs, every accuracy bound and every kernel phase stay at
# --n. 262,144 until group accuracy (125 s on an H100 80GB HBM3 at
# 700 W) needed the room
SMALL_N = 131072
TREE_KW = dict(max_depth=14, max_leaf_n=32, ncrit=512, tile_chunk=32,
               farfield="grid", m2p_cap=9728, p2p_leaf_cap=5888,
               p2p_src_cap=47104, frontier_cap=1024)
RTOL, ATOL_REL = 2e-4, 2e-5
WARM_REPS = 3
FORCE_RMS_MAX, POT_RMS_MAX = 5e-3, 2e-3
# BASELINE config #2 (benchmarks/configs.py:90-114); N and steps are cut
LF_KW = dict(max_depth=12, max_leaf_n=32, ncrit=512, tile_chunk=32,
             p2p_leaf_cap=4096, p2p_src_cap=49152, m2p_cap=12288)
LF_EPS, LF_BOX, LF_DT, LF_THETA, LF_STEPS = 0.02, 8.0, 1e-3, 0.75, 3
E_THETA = 0.25
DRIFT_MAX, E_POT_RMS_MAX = 2e-3, 1e-4
# The step configuration on a uniform-density sphere: monopole BH at
# theta=0.75 errs there by ~1.2-1.4e-2 in force RMS in the reference
# itself (the port gives the reference's forces on this configuration,
# tests/test_torch_integrate.py), so its bound is the top of that range;
# 5e-3 is the Plummer bound
LF_FORCE_RMS_MAX, LF_POT_RMS_MAX = 1.5e-2, 2e-3
# the card's published peaks (H100 SXM, 700 W): fp32 outside the tensor
# cores and HBM bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# fp32 operations per live (source, target) pair, counted from the
# kernel's inner loop (csrc/shared_fused.cu); TwoSum adds 6 operations
# per sum per target and staged granule, and per target and span in K1's
# span reduction
FLOPS_MONO, FLOPS_QUAD, FLOPS_TWOSUM = 20, 64, 24
# integer operations of K1c's cell test on every mask-true pair (on the
# packed cell word: 2 adds, 2 logic operations, 2 compares;
# csrc/shared_fused.cu); the 20 (64) fp32 operations are then counted on
# the pairs it leaves
OPS_CELL = 6
SRC = "rakau_tpu_torch/csrc/shared_fused.cu"
REPLACES = "rakau_tpu/kernels/pallas.py:566"
POOL_SRC = "rakau_tpu_torch/csrc/pool.cu"
POOL_REPLACES = "rakau_tpu/kernels/pallas.py:974"
# kernel sources under rakau_tpu_torch/csrc/, each with its float64 build or
# not, and their kernels (template instantiations: mode x compensated x
# quadrupole, and x cell test in K1, whose launch adds the three kernels
# of its plan, its row packing and its span reduction in two forms; K6:
# mode x cell test x precision, the same plan and packing kernels
# (shared_plan.cuh) and its reduction; K5: the same plan and packing
# kernels at blocks of 1024, its kernel and its reduction; K2's launch adds
# its work list and its reduction in two forms; K3 and K4 are a work list
# and a kernel each and one shared span reduction)
LIBRARIES = {("shared_fused", False): 42, ("pool", False): 15,
             ("shared_mma", False): 32, ("shared_blocks", False): 6,
             ("tiles", False): 5, ("shared_fused", True): 42,
             ("pool", True): 15, ("tiles", True): 5}
TILES_SRC = "rakau_tpu_torch/csrc/tiles.cu"
K3_REPLACES = "rakau_tpu/kernels/pallas.py:149"
K4_REPLACES = "rakau_tpu/kernels/pallas.py:42"
# the card's fp64 peak outside the tensor cores (H100 SXM, NVIDIA's data
# sheet), for the bounds of the float64 builds
PEAK_FP64 = 34e12
# a float64 kernel against its float64 plain version: the two sum in other
# orders (~1e-13 of the largest sum); a float32 kernel would be 1e-7 off
F64_RTOL, F64_ATOL_REL = 1e-9, 1e-10
# the lists path: the main phase's tree and caps (grown by the Tree), the
# M2P far field (the lists path reads no other)
LISTS_KW = dict(TREE_KW, traversal_mode="lists", farfield="m2p")
# the quadrupole on the lists path (plain-op route): particles, and its
# force RMS against shared+m2p with the quadrupole on the same particles
# (tests/test_engine.py:124-141)
LISTS_QUAD_N, LISTS_QUAD_RTOL = 262144, 0.1
# F1: 2-D and float64 trees on the card, at this size, with the bounds of
# tests/test_engine.py:83-93 (2-D, theta 0.5) and :181-190 (fp64, 0.4)
F1_N = 65536
F1_2D_THETA, F1_2D_MAX = 0.5, 2e-2
# ... and the 2-D shared+grid2 query at grid2's 2-D level cap, 10: leaf
# cells up to 1023, past what three 10-bit fields of the packed cell test
# hold (csrc/cell_test.cuh packs 2-D cells in two 15-bit fields)
F1_2D_GRID2_KW = dict(farfield="grid2", grid_level=10, local_order=4,
                      grid_sep=2)
F1_F64_THETA, F1_F64_FORCE_MAX = 0.4, 2e-3
MMA_SRC = "rakau_tpu_torch/csrc/shared_mma.cu"
MMA_REPLACES = "rakau_tpu/kernels/pallas.py:395"
BLOCKS_SRC = "rakau_tpu_torch/csrc/shared_blocks.cu"
BLOCKS_REPLACES = "rakau_tpu/kernels/pallas.py:283"
PRECS = ("bf16", "x3", "highest")
# K6 in one bf16 pass against its own bf16 plain version: the two round the
# same w3 to bfloat16, but their w3 differ in the last fp32 bits (the order
# of the sums feeding them does not; rsqrt and the products do), so a pair
# near a rounding boundary lands on either side: 2^-8 of that pair's term
# w3 |s'|, which the cancellation Y - ysum t' can leave several times larger
# than the pair's force
BF16_RTOL, BF16_ATOL_REL = 2e-2, 1e-2
# K6 at x3 and highest against its plain version: both compute the same
# w3 bit for bit, but acc = Y - ysum t' cancels (|Y| is 10-100x |acc| in a
# tile whose first target, the origin, lies a tile's width from the
# target), so the fp32 rounding of two orders of summation shows at ~1e-4
# of the largest result where K1's d = s - t form shows 1e-6
MMA_ATOL_REL = 5e-4
MODES = ("both", "acc", "pot")
# the plain pool version runs over this many tiles at a time ([tiles, T,
# pool_block] panels), and modes acc/pot are checked on this many tiles
PLAIN_TILES, SUBSET_TILES = 128, 256
# The quadrupole's force RMS over the monopole's: the reference's bound
# for its gwalk quadrupole headline (tests/test_gwalk.py:102-117; 0.5 at
# 4096 particles and theta 0.7, :120-130). At theta 0.75 the ratio grows
# with N (0.39 at 65,536 particles, 0.53 at 1M, on an H100), and the
# shared engine on the same particles gives the same errors, so the
# gwalk errors are also held to the shared engine's, within
# SHARED_RMS_RTOL.
QUAD_RMS_RATIO, SHARED_RMS_RTOL = 0.6, 0.01
# the shared engine's starting caps there (its Tree grows them)
SHARED_M2P_CAPS = dict(m2p_cap=16384, p2p_leaf_cap=8192, p2p_src_cap=131072,
                       frontier_cap=4096)
# the quadrupole's pool window in bench.py's gwalk run (bench.py:81-85)
QUAD_POOL_WINDOW = 131072
# grid2 on both traversals: order 4 and a separation of 3 cells; the
# accuracy variant raises the order to 6 with quadrupole node rows and
# compensated sums (the reference's accuracy shape, tests/test_gwalk.py)
GRID2_KW = dict(farfield="grid2", local_order=4, grid_sep=3)
GRID2_QUAD_KW = dict(local_order=6, multipole_order=2, accum="compensated")
# the float32 far field against float64 under TF32 switches turned on
TF32_REL_MAX = 1e-4
# the reference's lmac1m run (the stage of that name in its stage list
# under benchmarks/, on bench.py:54-78): lmac + grid2 order 4 / sep 2,
# monopole; frontier_cap holds the slice's candidate table
LMAC_KW = dict(max_depth=14, max_leaf_n=32, ncrit=512, tile_chunk=32,
               traversal_mode="lmac", farfield="grid2", local_order=4,
               grid_sep=2, m2p_cap=9728, p2p_leaf_cap=5888,
               p2p_src_cap=47104, frontier_cap=65536)
# lmac's force RMS over the shared engine's with the same far field, level
# and theta (tests/test_lmac.py:108-122)
LMAC_SHARED_RATIO = 1.1
# the reference's accuracy gate (the gate65k stage of the same list,
# tests/test_lmac.py:171-186): 65,536 particles, order 6 / sep 3,
# quadrupole, compensated, theta 0.5
GATE_N, GATE_THETA, GATE_FORCE_RMS_MAX = 65536, 0.5, 2e-4
GATE_KW = dict(LMAC_KW, local_order=6, grid_sep=3, multipole_order=2,
               accum="compensated")
# K6's fp32 operations a live pair as the reference counts them
# (pallas.py:415-420; csrc/shared_mma.cu spends ~16, its r2n without
# FMAs), the useful operations of its tensor-core product (W3 [T, B] x
# X [B, 3]: 6 a pair and pass) and the card's dense bf16 peak
FLOPS_MMA, TENSOR_FLOPS, PEAK_BF16 = 13, 6, 989e12
MMA_PASSES = {"bf16": 1, "x3": 3, "highest": 0}
# x3 and highest against the fused kernel's force RMS in a whole query
VARIANT_RMS_RTOL = 0.01
# One bf16 pass rounds w3 and s' to 8 bits: 2^-9 of |w3 s'| a pair, which
# Y - ysum t' leaves several times larger than a near pair's force. The
# reference has no test of its own for this precision; a whole query read
# 1.6e-2 force RMS at 65,536 particles on an H100, so it is held to 5e-2
# (an error of the arithmetic, not of the kernel: the plain version gives
# the same), the potential (no bf16 in it) to the usual bound.
BF16_FORCE_RMS_MAX = 5e-2
ROOF_SOURCES, ROOF_REPS = 262144, 8


def gwalk_kw(n: int) -> dict:
    """bench.py's gwalk configuration (bench.py:47-85 with
    RAKAU_BENCH_TRAVERSAL=gwalk): its global caps start from per-particle
    ratios."""
    return dict(max_depth=14, max_leaf_n=32, ncrit=512, tile_chunk=32,
                traversal_mode="gwalk", m2p_cap=3 * n, p2p_leaf_cap=n,
                p2p_src_cap=16 * n, frontier_cap=n // 4, pool_block=512,
                pool_window=262144, pool_group=8)


# the script's start, for the seconds each line states (`at_s`)
T0 = time.perf_counter()


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - T0}), flush=True)
    torch.cuda.synchronize()


def card_lines() -> list:
    """nvidia-smi's name and power limit of every card, a line each."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


def build_kernels() -> dict:
    """Build every kernel library from csrc/ (and the float64 builds), one
    nvcc process each, all started together. Returns the wall seconds and
    per library its ptxas registers and spill bytes per kernel; raises on
    a failed build or a spill in any kernel."""
    from concurrent.futures import ThreadPoolExecutor
    from rakau_tpu_torch.kernels import shared

    def one(key):
        t0 = time.perf_counter()
        path = shared.build_library(*key)
        return key, path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        built = list(ex.map(one, LIBRARIES))
    out = {"seconds": time.perf_counter() - t0, "libraries": {}}
    for key, path, secs in built:
        name = key[0] + ("_f64" if key[1] else "")
        ptxas = path.with_name(path.stem + ".ptxas.txt").read_text()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", ptxas)]
        rec = dict(seconds=secs, library=path.name, kernels=len(regs),
                   registers=regs, spill_bytes=spills)
        if key[0] in ("shared_fused", "shared_mma", "shared_blocks", "pool",
                      "tiles"):
            rec["registers_by_kernel"] = REGISTERS[name] = \
                kernel_registers(ptxas)
        if any(spills):
            rec["spilling"] = [f for f, b in zip(re.findall(
                r"Compiling entry function '([^']+)'", ptxas), spills) if b]
        out["libraries"][name] = rec
        if len(regs) != LIBRARIES[key] or any(spills):
            raise AssertionError(f"ptxas, {name}: {len(regs)} kernels "
                                 f"(want {LIBRARIES[key]}), spills {spills}"
                                 f" in {rec.get('spilling')}")
    return out


# registers of each kernel of K1's, K6's, K5's, K2's, K3's and K4's builds
# (build_kernels), by library ("pool", "pool_f64", ...) and
# kernel_registers' short name
REGISTERS: dict = {}


def kernel_registers(ptxas: str) -> dict:
    """Registers of each kernel of a build's ptxas report, by a short name:
    the kernel's name and its integer template arguments from the mangled
    name (shared_fused_kernel<mode,comp,quad,cell>, pool_kernel<mode,comp,
    quad>, rows_reduce_kernel<comp>, tiles_fused_kernel, ...)."""
    out = {}
    for name, regs in re.findall(
            r"Compiling entry function '([^']+)'.*?Used (\d+) registers",
            ptxas, flags=re.S):
        base, rest = entry_name(name)
        targs = re.match(r"I(.*?E)E", rest)
        vals = re.findall(r"L[ib](\d+)E", targs.group(1)) if targs else []
        out[base + (f"<{','.join(vals)}>" if vals else "")] = int(regs)
    return out


def entry_name(mangled: str) -> tuple:
    """(the kernel's name, the mangled text after it) of a mangled entry
    function: the first identifier, given by its length prefix, that ends
    in "kernel" or "reduce" (a length prefix may follow the digits of a
    namespace's hash, so every tail of a run of digits is tried)."""
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):
            n, at = int(digits[i:]), m.end()
            ident = mangled[at:at + n]
            if (len(ident) == n and re.fullmatch(r"[A-Za-z_]\w*", ident)
                    and ident.endswith(("kernel", "reduce"))):
                return ident, mangled[at + n:]
    return mangled, ""


def k1_shape(args, comp=False, quad=False, cells=None,
             mode: str = "both") -> dict:
    """K1's launch shape on these rows: the granules and spans of the
    wrapper's plan (shared.fused_plan), its work items, the CUDA blocks of
    its persistent grid, the blocks of this form that fit an SM and the
    warps an SM holds on average (4 a block, over the blocks that find an
    item)."""
    from rakau_tpu_torch.kernels import shared
    tpos, mask = args[0], args[5]
    C, T, D = tpos.shape
    S = int(args[2].shape[0])
    lib = shared._library("shared_fused", tpos.dtype == torch.float64)
    plan = shared.fused_plan(mask)
    sms = shared.multiprocessors(tpos.device)
    sep = cells[2] if cells else 0
    m = MODES.index(mode)
    grid = lib.rakau_shared_fused_grid(C, T, S, shared.SPAN, m, int(comp),
                                       int(quad), sep, D, sms)
    fit = lib.rakau_shared_fused_blocks_per_sm(m, int(comp), int(quad), sep,
                                               D)
    tpt = lib.rakau_shared_fused_targets_per_thread()
    items = int(plan.n_work[0]) * -(-T // (128 * tpt))
    return dict(granules=int(plan.cnt.sum()), spans=int(plan.n_work[0]),
                work_items=items, cuda_blocks=grid, blocks_per_sm_fit=fit,
                warps_per_sm=4 * min(grid, items) / sms, sms=sms)


def k6_shape(args, prec: str, cells=None, mode: str = "both") -> dict:
    """K6's launch shape on these rows, as k1_shape's: the granules and
    spans of its plan (K1's, shared.fused_plan), its work items of
    targets_per_item targets, the CUDA blocks of its persistent grid, the
    blocks of this form that fit an SM, the warps an SM holds on average
    and the form's registers (ptxas)."""
    from rakau_tpu_torch.kernels import shared
    tpos, mask = args[0], args[5]
    C, T, D = tpos.shape
    S = int(args[2].shape[0])
    lib = shared._library("shared_mma")
    plan = shared.fused_plan(mask)
    sms = shared.multiprocessors(tpos.device)
    sep = cells[2] if cells else 0
    m, pr = MODES.index(mode), shared.PRECS[prec]
    grid = lib.rakau_shared_mma_grid(C, T, S, shared.SPAN, m, pr, sep, D,
                                     sms)
    fit = lib.rakau_shared_mma_blocks_per_sm(m, pr, sep, D)
    tpi = lib.rakau_shared_mma_targets_per_item()
    items = int(plan.n_work[0]) * -(-T // tpi)
    cell = D if sep else 0
    regs = REGISTERS.get("shared_mma", {}).get(
        f"shared_mma_kernel<{m},{cell},{pr}>")
    return dict(granules=int(plan.cnt.sum()), spans=int(plan.n_work[0]),
                work_items=items, targets_per_item=tpi, cuda_blocks=grid,
                blocks_per_sm_fit=fit,
                warps_per_sm=lib.rakau_shared_mma_threads() // 32
                * min(grid, items) / sms, registers=regs, sms=sms)


def k5_shape(args) -> dict:
    """K5's launch shape on these rows: the active blocks and spans of its
    plan (shared.fused_plan at BLOCKS_SPAN and BLOCK), its work items, the
    CUDA blocks of its persistent grid, the blocks that fit an SM, the
    warps an SM holds on average (over the blocks that find an item), its
    staging step and threads a block and its kernel's registers
    (ptxas)."""
    from rakau_tpu_torch.kernels import shared
    tpos, mask = args[0], args[5]
    C, T, _ = tpos.shape
    S = int(args[2].shape[0])
    lib = shared._library("shared_blocks")
    plan = shared.fused_plan(mask, shared.BLOCKS_SPAN, shared.BLOCK)
    sms = shared.multiprocessors(tpos.device)
    grid = lib.rakau_shared_blocks_grid(C, T, S, shared.BLOCKS_SPAN, sms)
    tpt = lib.rakau_shared_blocks_targets_per_thread()
    threads = lib.rakau_shared_blocks_threads()
    items = int(plan.n_work[0]) * -(-T // (threads * tpt))
    return dict(blocks=int(plan.cnt.sum()), span=shared.BLOCKS_SPAN,
                spans=int(plan.n_work[0]), work_items=items,
                targets_per_thread=tpt, threads=threads,
                step=lib.rakau_shared_blocks_step(), cuda_blocks=grid,
                blocks_per_sm_fit=lib.rakau_shared_blocks_blocks_per_sm(),
                warps_per_sm=threads // 32 * min(grid, items) / sms, sms=sms,
                registers=REGISTERS.get("shared_blocks", {}).get(
                    "shared_blocks_kernel"))


# device cycles that cuda_ms keeps the card busy for before it times, so
# that the host enqueues the timed calls meanwhile (~10 ms)
PRIME_CYCLES = 20_000_000
# the measured keys of a kernel's row in the summary line
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
# the kernels' scalar buffers of the direct calls below, by value
_SCAL: dict = {}


def scal(eps, G, like):
    """The kernels' scalar buffer of eps and G in like's dtype on its
    device (kernels.shared.scalar_buffer), made at its first use and kept
    for the run: a timed direct call times its kernels, not the making of
    its arguments, as a query's launches take the buffer that
    engine.scalars made once for the call."""
    from rakau_tpu_torch.kernels import shared
    key = (float(eps), float(G), like.dtype, like.device)
    if key not in _SCAL:
        _SCAL[key] = shared.scalar_buffer(eps, G, like)
    return _SCAL[key]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (after one warm-up): the
    card first spins PRIME_CYCLES while the host enqueues the calls, so a
    call that takes the host longer than the card (K1's wrapper) is timed
    by the card's work, not by the host's launch rate."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(PRIME_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


@contextmanager
def synced(module, name: str, totals: dict):
    """Replace module.name, for the duration, by a wrapper that adds the
    wall ms of each call, taken between device syncs, to totals[name]."""
    orig = getattr(module, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        totals[name] = totals.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, orig)


def eager_query(tree, theta: float = THETA):
    """One query of `tree` as accs_pots_o runs it (the query, the overflow
    read, the inverse permutation) but eagerly: engine.acc_pot_u_host with
    graph=False. The per-layer phases run it so, since they time module
    functions between device syncs: a graph replay would run none of the
    patched functions and a capture refuses a sync."""
    from rakau_tpu_torch import engine
    td = tree.tree_data
    acc, pot, ovf, _ = engine.acc_pot_u_host(td, tree.config, theta, 0.0,
                                             graph=False)
    if any(ovf.cpu().tolist()):
        raise AssertionError(f"eager query overflowed: {ovf.tolist()}")
    return acc[td.inv_perm], pot[td.inv_perm]


def query_chunks(td, cfg) -> int:
    """The chunk evaluations of one query (engine.evaluated_chunks over
    its live chunks): every slice evaluates its K chunks, the last one,
    moved back, whole; a kernel that runs once a chunk launches this
    many times a query."""
    from rakau_tpu_torch import engine
    return engine.evaluated_chunks(engine.live_chunks(td, cfg),
                                   cfg.tile_chunk)


def synced_layers(tree, layers) -> tuple:
    """One warm query, run eagerly (eager_query), with each (module,
    name) of `layers` timed between device syncs. Returns (ms per name,
    synced query ms); the syncs add to the total."""
    t: dict = {}
    with ExitStack() as stack:
        for mod, name in layers:
            stack.enter_context(synced(mod, name, t))
        _, total = synced_ms(lambda: eager_query(tree))
    return t, total


def layer_ms(tree) -> dict:
    """The shared query split by layer: the walk (traversal2.
    build_shared_sources), the tile far field (engine._chunk_sources less
    the walk) and the kernel call (dispatch.eval_shared: active-block
    lists, K1a, the G scale). The rest is tile gathers, assembly, the
    overflow read and the inverse permutation."""
    from rakau_tpu_torch import engine, traversal2
    from rakau_tpu_torch.kernels import dispatch
    t, total = synced_layers(tree, ((traversal2, "build_shared_sources"),
                                    (engine, "_chunk_sources"),
                                    (dispatch, "eval_shared")))
    walk, walk_ff = t["build_shared_sources"], t["_chunk_sources"]
    kernel = t["eval_shared"]
    return {"walk_ms": walk, "farfield_ms": walk_ff - walk,
            "kernel_call_ms": kernel, "rest_ms": total - walk_ff - kernel,
            "synced_query_ms": total}


def gwalk_layer_ms(tree) -> dict:
    """The gwalk query split by layer: the global walk (traversal4.
    build_global_incidences), the pool build (traversal4.build_pool), the
    K2 call (dispatch.eval_pool) and the dense far field handed down to
    the tiles (engine._gwalk_farfield; with "grid2" the per-particle L2P,
    engine._add_grid2). The rest is the schedule, the
    overflow read, assembly and the inverse permutation."""
    from rakau_tpu_torch import engine, traversal4
    from rakau_tpu_torch.kernels import dispatch
    t, total = synced_layers(tree, ((traversal4, "build_global_incidences"),
                                    (traversal4, "build_pool"),
                                    (dispatch, "eval_pool"),
                                    (engine, "_gwalk_farfield"),
                                    (engine, "_add_grid2")))
    out = {"walk_ms": t["build_global_incidences"],
           "pool_build_ms": t["build_pool"],
           "kernel_call_ms": t["eval_pool"],
           "farfield_ms": t.get("_gwalk_farfield", 0.0) + t["_add_grid2"]}
    out["rest_ms"] = total - sum(out.values())
    out["synced_query_ms"] = total
    return out


# the kernels of K2's and K3's launches (their plan and span reduction
# beside the main kernel), for device_profile
K2_KERNELS = ("pool_kernel", "rows_work_kernel", "rows_reduce_kernel")
K3_KERNELS = ("tiles_fused_kernel", "rows_work_kernel", "rows_reduce_kernel")


def device_profile(tree, kernel, key: str, graph: bool = True) -> dict:
    """One warm query under torch.profiler with CUDA activity only: the
    number of device ops (kernels, copies, sets), the device-busy ms as
    the union of their intervals, and the share of the kernels whose name
    holds `kernel` (a string, or a tuple of them) (reported as `key`).
    graph: the query through the entry point (its CUDA graphs replayed);
    False: eager_query. `launches`: on a replay, the main kernels' records
    per form, held to the bookkeeping (profile_launches: the query is
    profiled again, at most PROFILE_TRIES times, until a run shows it;
    the ops and times are that run's); eagerly, the wrappers' counts, each
    taken where its launch returned, with the profile's beside them
    (`profiled_launches`)."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    run = (lambda: tree.accs_pots_o(THETA)) if graph else \
        (lambda: eager_query(tree))

    def timed():
        start.record()
        run()
        stop.record()
        stop.synchronize()

    _, launches, booked, events, tries = profile_launches(timed, hold=graph)
    ops, busy_ms, by_name = device_busy(events)
    k_ms = sum(ms for name, (ms, _) in by_name.items()
               if any(k in name for k in names))
    return {"profiled_query_ms": start.elapsed_time(stop),
            "device_ops": ops, "device_busy_ms": busy_ms,
            key: k_ms, "launches": launches if graph else booked,
            "profiled_launches": launches, "profile_runs": tries}


def device_busy(events) -> tuple:
    """(device ops, busy ms as the union of their intervals, {name: (ms,
    records)}) of a profile's device records (kineto events), leaving out
    the tiny spin kernels that torch.cuda._sleep launches."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in events:
        if e.device_type() != DeviceType.CUDA or "spin_kernel" in e.name():
            continue
        a = e.start_ns()
        spans.append((a, a + e.duration_ns()))
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    busy_ns, end = 0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    return len(spans), busy_ns / 1e6, by_name


def top_ops(by_name: dict, k: int = 6) -> list:
    """The k device ops with the most device time: (name cut to 90
    characters, ms, records)."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:k]
    return [(name[:90], ms, n) for name, (ms, n) in top]


def profile_record(prof: dict, warm_ms: float) -> dict:
    return dict(prof, launches=nonzero(prof["launches"]),
                profiled_launches=nonzero(prof["profiled_launches"]),
                warm_query_ms=warm_ms,
                idle_share=1 - prof["device_busy_ms"] / warm_ms,
                idle_share_profiled=1 - prof["device_busy_ms"]
                / prof["profiled_query_ms"])


# graphed and eager warm queries of the graphs phase, each (in turns)
GRAPH_REPS = 5
# the eager ways take fewer of those turns (the first ones): an eager 1M
# query or step takes 3.5-4.5 s, and two give its median and spread
EAGER_REPS = 2
MB = 1 << 20


def graph_pool_mb() -> float:
    """Device memory the CUDA graphs' pools hold (segments of private
    pools in the allocator's snapshot), in MiB."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / MB


def graph_ab(tree, label: str, forms: dict, kernel, key: str) -> dict:
    """Phase graphs, one query: `tree`'s query through
    engine.acc_pot_u_host replayed from its CUDA graphs (graph=None, the
    default on the card) against the same query run eagerly
    (graph=False), on one tree in one call. The graph cache is emptied
    first, so the first graphed query captures (its warm-up, capture and
    replay: capture_s); then GRAPH_REPS warm queries each way (eagerly in
    the first EAGER_REPS turns only), in turns (the query and the
    overflow read, synced wall ms), each with the
    launch counts of `forms` ({module key: {form: launches}}, counted)
    and no other; the peak memory of each (max_memory_allocated over the
    memory held before it); a profile of each (device_profile with
    `kernel` and `key`), whose records of the main kernels must show the
    launches of `forms` (the timed queries' counts are the bookkeeping,
    held to the same). Raises unless the graphed sums equal the eager
    ones bit for bit and the flags and maxima are equal. Emits and
    returns the record."""
    from rakau_tpu_torch import engine
    td, cfg = tree.tree_data, tree.config

    def run(graph):
        out = engine.acc_pot_u_host(td, cfg, THETA, 0.0, graph=graph)
        out[2].cpu()            # the overflow read of the Tree's query
        return out

    engine.clear_graphs()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (_, capture_ms), counts = counted(lambda: synced_ms(lambda: run(None)))
    rec = {"query": label, "capture_s": capture_ms / 1e3,
           "capture_peak_mb": (torch.cuda.max_memory_allocated() - base)
           / MB, "graphs_cached": len(engine._GRAPHS),
           "capture_launches": counts}
    torch.cuda.synchronize()
    rec["graph_held_mb"] = (torch.cuda.memory_allocated() - base) / MB
    rec["graph_pool_mb"] = graph_pool_mb()
    ms = {False: [], True: []}
    peak = {False: [], True: []}
    out = {}
    want = None
    for i in range(GRAPH_REPS):
        for graph in ((False, True) if i % 2 == 0 else (True, False)):
            if not graph and i >= EAGER_REPS:
                continue
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            (out[graph], t), counts = counted(
                lambda: synced_ms(lambda: run(graph)))
            peak[graph].append((torch.cuda.max_memory_allocated() - held)
                               / MB)
            ms[graph].append(t)
            want = want or launched(counts, forms)
            if counts != want:
                raise AssertionError(
                    f"graphs {label} (graph={graph}): launches {counts}, "
                    f"want {forms} and nothing else")
    (a_e, p_e, o_e, m_e), (a_g, p_g, o_g, m_g) = out[False], out[True]
    rec.update(
        launches_per_query=forms,
        max_abs_diff_acc=float((a_g - a_e).abs().max()),
        max_abs_diff_pot=float((p_g - p_e).abs().max()),
        flags_equal=bool(torch.equal(o_g, o_e)),
        maxima_equal=bool(torch.equal(m_g, m_e)), overflow=o_g.tolist())
    for graph, side in ((False, "eager"), (True, "graphed")):
        med = statistics.median(ms[graph])
        prof = device_profile(tree, kernel, key, graph=graph)
        if prof["launches"] != want:
            raise AssertionError(
                f"graphs {label} (graph={graph}): launches on the card's "
                f"profile {nonzero(prof['launches'])}, want {forms}")
        rec[side] = dict(
            profile_record(prof, med), warm_query_ms_all=ms[graph],
            warm_spread=(max(ms[graph]) - min(ms[graph])) / med,
            peak_mb=max(peak[graph]))
    rec["speedup"] = (rec["eager"]["warm_query_ms"]
                      / rec["graphed"]["warm_query_ms"])
    emit("graphs", **rec)
    if not (torch.equal(a_g, a_e) and torch.equal(p_g, p_e)
            and rec["flags_equal"] and rec["maxima_equal"]):
        raise AssertionError(f"graphs {label}: the graphed query differs "
                             f"from the eager one: {rec}")
    return rec


def acc_pot_u_check(tree) -> dict:
    """Phase graphs: engine.acc_pot_u, the whole query as one CUDA graph
    (every chunk of the tile capacity, tiles, tables and far field built
    inside), on `tree` against engine.acc_pot_u_host run eagerly: equal
    sums and flags, K1a launches a replay = the chunks of the tile
    capacity (stated beside the live chunks), measured on a profiled
    replay. Emits and returns the record."""
    from rakau_tpu_torch import engine
    td, cfg = tree.tree_data, tree.config
    cap_chunks = engine._gather_tiles(td, cfg)[0].shape[0]
    live = engine.live_chunks(td, cfg)
    engine.clear_graphs()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, capture_ms = synced_ms(lambda: engine.acc_pot_u(
        td, cfg, THETA, 0.0, with_stats=True))
    capture_peak = (torch.cuda.max_memory_allocated() - base) / MB
    pool_mb = graph_pool_mb()
    warm, booked = [], None
    for _ in range(2):
        ((acc, pot, ovf, mx), t), booked = counted(lambda: synced_ms(
            lambda: engine.acc_pot_u(td, cfg, THETA, 0.0, with_stats=True)))
        warm.append(t)
    # one more replay under the profiler: the launches it ran
    _, counts = measured(lambda: engine.acc_pot_u(
        td, cfg, THETA, 0.0, with_stats=True), want=booked)
    (a_h, p_h, o_h, m_h), host_ms = synced_ms(lambda: engine.acc_pot_u_host(
        td, cfg, THETA, 0.0, graph=False))
    rec = {"query": "acc_pot_u (shared+grid)", "n": int(td.pos.shape[0]),
           "capture_s": capture_ms / 1e3,
           "capture_peak_mb": capture_peak, "graph_pool_mb": pool_mb,
           "warm_ms_all": warm,
           "eager_host_query_ms": host_ms, "capacity_chunks": cap_chunks,
           "live_chunks": live, "launches_per_replay": nonzero(counts),
           "max_abs_diff_acc": float((acc - a_h).abs().max()),
           "max_abs_diff_pot": float((pot - p_h).abs().max()),
           "overflow": ovf.tolist(), "maxima": mx.tolist(),
           "host_maxima": m_h.tolist()}
    emit("graphs", **rec)
    if counts != launched(counts, {"K1": {"mono": cap_chunks}}):
        raise AssertionError(f"acc_pot_u: launches {counts}, want "
                             f"{cap_chunks} K1a (the tile capacity)")
    if not (torch.equal(acc, a_h) and torch.equal(pot, p_h)
            and torch.equal(ovf, o_h)):
        raise AssertionError(f"acc_pot_u differs from acc_pot_u_host: {rec}")
    return rec


@contextmanager
def engine_graph(graph):
    """Inside, every call of engine.acc_pot_u_host and engine.build_tree
    runs with `graph` (False: eagerly; None: from CUDA graphs on the
    card), whatever its caller passes (the LET's builds and local query
    take the default)."""
    from rakau_tpu_torch import engine
    origs = {name: getattr(engine, name)
             for name in ("acc_pot_u_host", "build_tree")}

    def forced(orig):
        def call(*a, **kw):
            kw["graph"] = graph
            return orig(*a, **kw)
        return call

    for name, orig in origs.items():
        setattr(engine, name, forced(orig))
    try:
        yield
    finally:
        for name, orig in origs.items():
            setattr(engine, name, orig)


def warm_stats(ms: list) -> dict:
    med = statistics.median(ms)
    return {"warm_ms": med, "warm_ms_all": ms,
            "warm_spread": (max(ms) - min(ms)) / med}


def profiled(fn, want: dict, warm_ms: float) -> dict:
    """One more call of fn under the profiler (profile_launches), its
    launches held to `want` (the counts of the timed calls; {}: none, as
    in a build): the measured
    launches, device ops, busy ms, idle share against warm_ms (the timed
    calls' median) and the ops with the most device time."""
    _, got, _, events, tries = profile_launches(fn)
    if nonzero(got) != nonzero(want):
        raise AssertionError(f"launches on the card's profile {nonzero(got)}"
                             f", of the timed calls {nonzero(want)}")
    ops, busy, by_name = device_busy(events)
    return {"launches": nonzero(got), "device_ops": ops,
            "device_busy_ms": busy, "idle_share": 1 - busy / warm_ms,
            "top_ops": top_ops(by_name), "profile_runs": tries}


def first_call(fn) -> tuple:
    """(fn(), its synced seconds, the MiB its new graph pins (static inputs
    and outputs), the allocator's peak over the memory held before it, the
    graph pools' MiB after it, the captures it made): the first call of a
    whole-call function, which runs its warm-up, capture and replay."""
    from rakau_tpu_torch import engine
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine._GRAPHS.reset_tally()
    out, ms = synced_ms(fn)
    name, pinned = engine._GRAPHS.pinned()[-1]     # the one just used
    return out, {"capture_s": ms / 1e3, "graph": name,
                 "pinned_mb": pinned / MB,
                 "capture_peak_mb": (torch.cuda.max_memory_allocated()
                                     - base) / MB,
                 "graph_pool_mb": graph_pool_mb(),
                 "captures": engine._GRAPHS.captures}


def build_ab(pos, mass, cfg, box, label: str) -> dict:
    """Phase graphs, the tree build: engine.build_tree replayed from its
    CUDA graph against the same build run eagerly (graph=False) on the
    same particles. The graph cache is emptied, so the first graphed build
    captures (first_call); then GRAPH_REPS warm builds each way in turns
    (synced wall ms). Raises unless every TreeData field of the graphed
    build equals the eager one's (torch.equal) and neither overflowed.
    Emits and returns the record."""
    from rakau_tpu_torch import engine
    engine.clear_graphs()
    _, rec = first_call(lambda: engine.build_tree(pos, mass, cfg, box))
    rec = {"build": label, "n": pos.shape[0], **rec}
    ms, out = {False: [], True: []}, {}
    for i in range(GRAPH_REPS):
        for graph in ((False, True) if i % 2 == 0 else (True, False)):
            out[graph], t = synced_ms(lambda: engine.build_tree(
                pos, mass, cfg, box, graph=graph))
            ms[graph].append(t)
    differ = [f for f, a, b in zip(out[True]._fields, out[True], out[False])
              if not torch.equal(a, b)]
    prof = {graph: profiled(lambda: engine.build_tree(
        pos, mass, cfg, box, graph=graph), {}, statistics.median(ms[graph]))
        for graph in (False, True)}
    rec.update(eager=dict(warm_stats(ms[False]), **prof[False]),
               graphed=dict(warm_stats(ms[True]), **prof[True]),
               n_nodes=int(out[True].n_nodes),
               n_tiles=int(out[True].n_tiles), fields_differing=differ,
               overflow=bool(out[True].overflow or out[False].overflow))
    rec["speedup"] = rec["eager"]["warm_ms"] / rec["graphed"]["warm_ms"]
    emit("graphs", **rec)
    if differ or rec["overflow"]:
        raise AssertionError(f"graphs build {label}: {rec}")
    return rec


# the sweep of phase sweep: (theta, eps, G) of each warm query after the
# main one's, each a new value of one of the three (a wider theta: a
# narrower one opens more nodes, and a list that overflows grows the
# Tree's caps, a new configuration, which captures)
SWEEP = ((0.9, 0.0, 1.0), (0.9, 1e-3, 1.0), (0.9, 1e-3, 0.5))


def scalar_sweep(tree, acc0) -> dict:
    """Phase sweep: the main tree queried at each (theta, eps, G) of SWEEP
    after its warm queries: theta, eps and G are inputs of the query's
    graphs, so no call captures one (the graph cache's count), and each
    gives other sums than the one before (the new value reached the
    card); CUDA-event ms of each, beside the main warm query."""
    from rakau_tpu_torch import engine
    rec, prev, cfg = [], acc0, tree.config
    for theta, eps, G in SWEEP:
        engine._GRAPHS.reset_tally()
        (acc, _), ms = event_ms(lambda: tree.accs_pots_o(theta, eps, G))
        rec.append(dict(theta=theta, eps=eps, G=G, ms=ms,
                        captures=engine._GRAPHS.captures,
                        differs=not torch.equal(acc, prev),
                        caps_unchanged=tree.config == cfg))
        prev = acc
    emit("sweep", calls=rec)
    if any(r["captures"] or not r["differs"] or not r["caps_unchanged"]
           for r in rec):
        raise AssertionError(f"sweep: a new theta, eps or G captured a "
                             f"graph or changed nothing: {rec}")
    return rec


def rebuild_captures(tree, pos) -> dict:
    """Phase graphs: a Tree rebuild at the same N (update_positions_o with
    the same positions) replays the build's graph. The first rebuild may
    capture (a query that grew a cap changed the config, which keys the
    build's graph); the second must capture nothing. Emits and returns the
    record."""
    from rakau_tpu_torch import engine
    engine._GRAPHS.reset_tally()
    _, first_ms = synced_ms(lambda: tree.update_positions_o(pos))
    first = engine._GRAPHS.captures
    engine._GRAPHS.reset_tally()
    _, ms = synced_ms(lambda: tree.update_positions_o(pos))
    rec = {"rebuild": "Tree.update_positions_o, same N", "n": pos.shape[0],
           "first_ms": first_ms, "first_captures": first, "ms": ms,
           "captures": engine._GRAPHS.captures,
           "captured": nonzero({"K1": engine._GRAPHS.captured[0]})}
    emit("graphs", **rec)
    if rec["captures"] or rec["captured"]:
        raise AssertionError(f"graphs: a steady-state Tree rebuild "
                             f"captured: {rec}")
    return rec


# warm steps of the whole-step comparison, each way (in turns)
STEP_REPS = 3


def in_turns(ways: dict, reps: int, what: str) -> tuple:
    """reps warm calls of each way ({name: fn}) in turns, the order
    reversed every other round, a way named "eager" in the first
    EAGER_REPS rounds only: (the last output of each way, synced wall ms
    of each call by way, the launches each way's calls booked (counted),
    the graphs their calls captured). Raises where two calls of a way
    booked different launches."""
    from rakau_tpu_torch import engine
    ms, booked, outs, captures = {w: [] for w in ways}, {}, {}, 0
    for i in range(reps):
        for w in (list(ways) if i % 2 else list(ways)[::-1]):
            if w == "eager" and i >= EAGER_REPS:
                continue
            ((outs[w], t), counts) = counted(lambda: synced_ms(ways[w]))
            captures += engine._GRAPHS.captures
            ms[w].append(t)
            if booked.setdefault(w, counts) != counts:
                raise AssertionError(f"{what} {w}: launches {counts}, "
                                     f"then {booked[w]}")
    return outs, ms, booked, captures


def step_three_ways(state, cfg) -> dict:
    """Phase graphs: one leapfrog step of BASELINE config #2 from `state`,
    three ways: integrate.leapfrog_step_morton, the whole step as one
    CUDA graph ("whole": its two builds and two queries over every chunk
    of the tile capacity); leapfrog_step_morton_host ("sliced": each
    build's graph, each query's slices and tail); the host twin run
    eagerly ("eager", graph=False). The whole step's first call is timed
    and its memory read (first_call); then STEP_REPS warm steps each way
    in turns (synced wall ms, K1a launches by bookkeeping), and one
    profiled replay of each graphed way, whose K1a launches measured on
    the card must be 2 x the tile capacity's chunks (whole) and 2 x the
    chunk evaluations of the live chunks (sliced). Then a whole step at
    -dt must capture nothing and equal the sliced one. Raises unless pos,
    vel and step_perm are bit-equal across the three and no flag is set.
    Emits and returns the record."""
    from rakau_tpu_torch import build, engine, integrate
    args = (state, LF_DT, cfg, LF_THETA, LF_EPS)
    ways = {
        "whole": lambda: integrate.leapfrog_step_morton(
            *args, box_size=LF_BOX),
        "sliced": lambda: integrate.leapfrog_step_morton_host(
            *args, box_size=LF_BOX),
        "eager": lambda: integrate.leapfrog_step_morton_host(
            *args, box_size=LF_BOX, graph=False)}
    td0 = build.build_tree(state.pos, state.mass, cfg, LF_BOX)
    cap = engine._gather_tiles(td0, cfg)[0].shape[0]
    ways["sliced"]()                    # its graphs, as a step finds them
    _, first = first_call(ways["whole"])
    outs, ms, booked, _ = in_turns(ways, STEP_REPS, "graphs step")
    # another step size (-dt) replays the whole step's graph: dt is an
    # input, not part of its key
    engine._GRAPHS.reset_tally()
    back = integrate.leapfrog_step_morton(state, -LF_DT, cfg, LF_THETA,
                                          LF_EPS, box_size=LF_BOX)
    back_captures = engine._GRAPHS.captures
    back_host = integrate.leapfrog_step_morton_host(
        state, -LF_DT, cfg, LF_THETA, LF_EPS, box_size=LF_BOX)
    back_equal = (torch.equal(back[0].pos, back_host[0].pos)
                  and torch.equal(back[0].vel, back_host[0].vel)
                  and torch.equal(back[2], back_host[2]))
    new = outs["whole"][0]
    td1 = build.build_tree(new.pos, new.mass, cfg, LF_BOX)
    evaluated = query_chunks(td0, cfg) + query_chunks(td1, cfg)
    want = {"whole": 2 * cap, "sliced": evaluated, "eager": evaluated}
    stats = {w: warm_stats(ms[w]) for w in ways}
    for w in ("whole", "sliced"):
        stats[w].update(profiled(ways[w], booked[w], stats[w]["warm_ms"]))
    rec = {"step": "leapfrog_step_morton (BASELINE config #2)",
           "n": state.pos.shape[0], "whole_first_call": first,
           "capacity_chunks": cap, "live_chunks": [
               engine.live_chunks(td0, cfg), engine.live_chunks(td1, cfg)],
           "k1a_launches_booked": {w: c["K1"]["mono"]
                                   for w, c in booked.items()},
           "k1a_launches_measured": {
               w: stats[w]["launches"]["K1"]["mono"]
               for w in ("whole", "sliced")},
           "k1a_launches_want": want, **stats}
    ref = outs["eager"]
    rec["bit_equal_to_eager"] = {
        w: [bool(torch.equal(a, b)) for a, b in (
            (o[0].pos, ref[0].pos), (o[0].vel, ref[0].vel), (o[2], ref[2]))]
        for w, o in outs.items() if w != "eager"}
    rec["overflow"] = [o[1].tolist() for o in outs.values()]
    rec["whole_over_sliced"] = (rec["whole"]["warm_ms"]
                                / rec["sliced"]["warm_ms"])
    rec["minus_dt"] = {"captures": back_captures,
                       "equal_to_sliced": back_equal}
    emit("graphs", **rec)
    if back_captures or not back_equal:
        raise AssertionError(f"graphs step at -dt: {rec['minus_dt']}")
    if (not all(all(v) for v in rec["bit_equal_to_eager"].values())
            or any(any(o) for o in rec["overflow"])
            or any(booked[w] != launched(booked[w], {"K1": {"mono": n}})
                   for w, n in want.items())):
        raise AssertionError(f"graphs leapfrog step: {rec}")
    return rec


def energy_two_ways(state, ecfg) -> dict:
    """Phase graphs: integrate.total_energy, the build and the pots-only
    query over the tile capacity as one CUDA graph, against
    total_energy_host (the build's graph, the sliced query) on the same
    state: the whole call's first call (first_call), STEP_REPS warm calls
    each way in turns, and a profiled replay of each, whose K1d+K1b and K1b
    launches measured on the card must be the tile capacity's chunks
    (whole) and the chunk evaluations (host). Raises unless the two
    energies agree to 1 ulp of the float64 sum. Emits and returns the
    record."""
    from rakau_tpu_torch import build, engine, integrate
    args = (state, ecfg, E_THETA, LF_EPS)
    ways = {"whole": lambda: integrate.total_energy(*args, box_size=LF_BOX),
            "host": lambda: integrate.total_energy_host(*args,
                                                        box_size=LF_BOX)}
    td = build.build_tree(state.pos, state.mass, ecfg, LF_BOX)
    want = {"whole": engine._gather_tiles(td, ecfg)[0].shape[0],
            "host": query_chunks(td, ecfg)}
    ways["host"]()                      # its graphs, as a query finds them
    _, first = first_call(ways["whole"])
    es, ms, booked, _ = in_turns(ways, STEP_REPS, "graphs energy")
    stats = {w: warm_stats(ms[w]) for w in ways}
    for w in ways:
        stats[w].update(profiled(ways[w], booked[w], stats[w]["warm_ms"]))
    rec = {"energy": "total_energy (BASELINE config #2, theta 0.25, "
                     "quadrupole, compensated)",
           "n": state.pos.shape[0], "whole_first_call": first,
           "energies": es, "diff_ulp": abs(es["whole"] - es["host"])
           / math.ulp(abs(es["host"])),
           "launches_measured": {w: stats[w]["launches"] for w in ways},
           "chunks_want": want, **stats}
    rec["whole_over_host"] = rec["whole"]["warm_ms"] / rec["host"]["warm_ms"]
    emit("graphs", **rec)
    forms = ("quad_comp", "mono_comp")
    if not (rec["diff_ulp"] <= 1 and all(
            booked[w] == launched(booked[w], {"K1": dict.fromkeys(forms, n)})
            for w, n in want.items())):
        raise AssertionError(f"graphs energy: {rec}")
    return rec


# the reference's single-chip entry point (__graft_entry__.py): a Plummer
# sphere through integrate.acc_pot, theta THETA, eps 0.01, at its config
GRAFT_N, GRAFT_EPS = 16384, 0.01
GRAFT_KW = dict(max_depth=10, max_leaf_n=32, ncrit=128, tile_chunk=32)


def graft_entry(seed: int, dev) -> dict:
    """Phase graphs: the counterpart of __graft_entry__.py's entry(),
    integrate.acc_pot as one CUDA graph on its configuration. Its default
    caps overflow there (the reference's executable ignores the flags and
    returns truncated forces), so the caps are grown first through the
    Tree API (grow and retry). At this size, where a launch costs what
    the work does: the build graphed against eager (build_ab), and
    acc_pot against acc_pot_host (GRAPH_REPS warm calls each way in turns,
    bit-equal). The first call captures; a replay's K1a launches measured
    = the tile capacity's chunks; force RMS at 1024 sampled targets
    against the float64 direct sum < FORCE_RMS_MAX; then overflow_refused.
    Emits and returns the record."""
    from rakau_tpu_torch import (Tree, build, direct_acc_pot_np, engine,
                                 integrate, particles)
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(GRAFT_N, generator=gen)
    tree = Tree(coords=pos, masses=mass, config=TreeConfig(**GRAFT_KW))
    tree.accs_pots_o(THETA, GRAFT_EPS)
    cfg = tree.config
    build_rec = build_ab(pos, mass, cfg, None, "graft entry")

    ways = {"whole": lambda: integrate.acc_pot(pos, mass, cfg, THETA,
                                               GRAFT_EPS),
            "host": lambda: integrate.acc_pot_host(pos, mass, cfg, THETA,
                                                   GRAFT_EPS)}
    _, first = first_call(ways["whole"])
    _, host_first = first_call(ways["host"])
    ms, outs = {w: [] for w in ways}, {}
    for i in range(GRAPH_REPS):
        for w in (list(ways) if i % 2 else list(ways)[::-1]):
            outs[w], t = synced_ms(ways[w])
            ms[w].append(t)
    (acc, pot, ovf), counts = counted(ways["whole"])
    _, counts = measured(ways["whole"], want=counts)
    cap = engine._gather_tiles(build.build_tree(pos, mass, cfg), cfg)[0]
    samp = np.sort(np.random.default_rng(seed).choice(GRAFT_N, 1024,
                                                      replace=False))
    acc_o, pot_o = direct_acc_pot_np(pos.double().cpu().numpy(),
                                     mass.double().cpu().numpy(),
                                     eps=GRAFT_EPS, targets=samp)
    f_rms, p_rms = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
    stats = {w: warm_stats(ms[w]) for w in ways}
    rec = {"entry": "integrate.acc_pot (the graft entry's configuration)",
           "n": GRAFT_N, "theta": THETA, "eps": GRAFT_EPS,
           "caps_grown": {f: getattr(cfg, f) for f in (
               "m2p_cap", "p2p_leaf_cap", "p2p_src_cap", "frontier_cap")},
           "first_call": first, "host_first_call": host_first,
           "whole": stats["whole"], "host": stats["host"],
           "whole_over_host": (stats["whole"]["warm_ms"]
                               / stats["host"]["warm_ms"]),
           "bit_equal_to_host": all(
               torch.equal(a, b) for a, b in zip(outs["whole"],
                                                 outs["host"])),
           "build_graphed_over_eager": 1 / build_rec["speedup"],
           "overflow": ovf.tolist(),
           "launches": nonzero(counts), "capacity_chunks": cap.shape[0],
           "force_rms": f_rms, "pot_rms": p_rms}
    emit("graphs", **rec)
    if (ovf.any() or not f_rms < FORCE_RMS_MAX
            or not rec["bit_equal_to_host"]
            or counts != launched(counts, {"K1": {"mono": cap.shape[0]}})):
        raise AssertionError(f"graphs graft entry: {rec}")
    rec["overflow_refused"] = overflow_refused(pos, mass, cfg, acc, pot)
    return rec


def overflow_refused(pos, mass, cfg, acc, pot) -> dict:
    """Phase graphs: a whole call on a build that overflows its node or
    tile capacity (node_cap 4, then tile_cap 4) captures and replays the
    query on that tree, and the wrapper raises RuntimeError ("... build
    overflowed ...") after the replay: integrate.acc_pot and
    leapfrog_step_morton on the graft entry's particles (at rest, auto
    box). Then the normal calls replay (no capture) and give what they
    gave before (acc, pot: the graft entry's). Emits and returns the
    record."""
    from rakau_tpu_torch import engine, integrate
    state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)
    calls = {
        "acc_pot": lambda c: integrate.acc_pot(pos, mass, c, THETA,
                                               GRAFT_EPS)[:2],
        "leapfrog_step_morton": lambda c: integrate.leapfrog_step_morton(
            state, LF_DT, c, THETA, GRAFT_EPS)}
    before = {"acc_pot": (acc, pot),
              "leapfrog_step_morton": calls["leapfrog_step_morton"](cfg)}
    rec = {}
    for name, call in calls.items():
        for cap in ("node_cap", "tile_cap"):
            try:
                call(cfg.with_(**{cap: 4}))
                rec[f"{name} {cap}=4"] = "no error"
            except RuntimeError as e:
                rec[f"{name} {cap}=4"] = str(e)
    torch.cuda.synchronize()
    engine._GRAPHS.reset_tally()
    after = {name: call(cfg) for name, call in calls.items()}
    rec["captures_after"] = engine._GRAPHS.captures
    rec["equal_after"] = {name: _leaves_equal(before[name], after[name])
                          for name in calls}
    emit("graphs", overflow_refused=rec)
    if (rec["captures_after"] or not all(rec["equal_after"].values())
            or not all("build overflowed" in v for k, v in rec.items()
                       if k.endswith("=4"))):
        raise AssertionError(f"graphs overflowed builds: {rec}")
    return rec


def _leaves_equal(a, b) -> bool:
    """Whether two nests of tuples of tensors are equal leaf by leaf."""
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return len(a) == len(b) and all(_leaves_equal(x, y)
                                   for x, y in zip(a, b))


def graphs_summary(queries: dict, mrec: dict, whole: dict) -> dict:
    """The graphs phase in one record: for each query its graphed and
    eager warm medians, device ops, busy ms, idle shares, peak memory and
    capture seconds; acc_pot_u's; the sharded query at LET_SHARDS shards
    against the single-device one and the LET's accuracy (both run on the
    graphs, phase multi) and phase multi's whole twins against their
    _host twins; then `whole`: the builds, the Tree rebuild, the config #2
    step three ways, its energy two ways and the graft entry."""
    out = {}
    for label, r in queries.items():
        if "eager" not in r:
            out[label] = {k: r[k] for k in (
                "capture_s", "graph_pool_mb", "warm_ms_all",
                "eager_host_query_ms",
                "capacity_chunks", "live_chunks", "max_abs_diff_acc")}
            continue
        out[label] = {"capture_s": r["capture_s"], "speedup": r["speedup"],
                      "capture_peak_mb": r["capture_peak_mb"],
                      "graph_held_mb": r["graph_held_mb"],
                      "graph_pool_mb": r["graph_pool_mb"],
                      "max_abs_diff_acc": r["max_abs_diff_acc"],
                      "max_abs_diff_pot": r["max_abs_diff_pot"]}
        for side in ("eager", "graphed"):
            out[label][side] = {k: r[side][k] for k in (
                "warm_query_ms", "warm_spread", "device_ops",
                "device_busy_ms", "idle_share", "peak_mb")}
    shard = mrec["sharded"]["shards"][LET_SHARDS]
    out["sharded"] = {"shards": LET_SHARDS, "query_s": shard["query_s"],
                      "max_abs_diff_acc": shard["max_abs_diff_acc"],
                      "max_abs_diff_pot": shard["max_abs_diff_pot"]}
    out["let"] = {k: mrec["let"].get(k) for k in (
        "force_rms", "pot_rms", "let_query_s", "local_query_graph_ab")}
    # the whole twins of phase multi against their _host twins
    out["sharded_whole"] = {
        k: {"capture_s": r["first_call"]["capture_s"],
            "whole_ms": r["whole"]["warm_ms"], "host_ms": r["host"]["warm_ms"],
            "k1a_launches_measured": r["k1a_launches_measured"]}
        for k, r in mrec["sharded_whole"].items()
        if k in MULTI_SHARDS and "first_call" in r}
    sw = mrec["step_whole"]
    out["step_whole"] = {"capture_s": sw["first_call"]["capture_s"],
                         **{w: sw[w]["warm_ms"] for w in ("sharded_whole",
                                                          "sharded_host")}}
    out["let_whole"] = {
        phase0: {"capture_s": r["first_call"]["capture_s"],
                 "whole_s": r["whole"]["warm_ms"] / 1e3,
                 "host_s": r["host"]["warm_ms"] / 1e3}
        for phase0, r in mrec["let"]["whole"].items()}
    for label, r in whole.items():
        first = r.get("first_call") or r.get("whole_first_call") or r
        out[label] = {k: first[k] for k in (
            "capture_s", "pinned_mb", "capture_peak_mb", "graph_pool_mb")
            if k in first}
        out[label].update({w: r[w]["warm_ms"] for w in (
            "eager", "graphed", "whole", "sliced", "host") if w in r})
        out[label].update({k: r[k] for k in (
            "k1a_launches_measured", "launches_measured", "diff_ulp",
            "force_rms", "captures", "warm_ms", "whole_over_host",
            "build_graphed_over_eager") if k in r})
    return out


def on_card(arrays, dev, dtype=torch.float32):
    """numpy arrays -> tensors on dev, the floating ones in dtype."""
    return [torch.as_tensor(a, device=dev).to(dtype)
            if np.asarray(a).dtype.kind == "f"
            else torch.as_tensor(a, device=dev) for a in arrays]


def tol(dtype) -> dict:
    """compare()'s tolerance for a kernel in dtype against its plain
    version."""
    if dtype == torch.float64:
        return dict(rtol=F64_RTOL, atol_rel=F64_ATOL_REL)
    return {}


def compare(got, want, rtol=RTOL, atol_rel=ATOL_REL):
    """Max |got - want| over (acc, pot); raises past the tolerance."""
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError("kernel output is not finite")
        err = (g - w).abs()
        scale = float(w.abs().max())
        bound = rtol * w.abs() + atol_rel * scale
        if bool((err > bound).any()):
            raise AssertionError(
                f"kernel vs plain: max err {float(err.max()):.3e} past "
                f"rtol {rtol} + atol {atol_rel}*{scale:.3e}")
        worst = max(worst, float(err.max()))
    return worst


def mma_tol(prec: str) -> dict:
    """compare()'s tolerance for K6 at `prec` against its plain version."""
    if prec == "bf16":
        return dict(rtol=BF16_RTOL, atol_rel=BF16_ATOL_REL)
    return dict(atol_rel=MMA_ATOL_REL)


def row_case(rng, C, T, S, only_last_block=False):
    """A made shared row for K5 and K6: a source exactly on a target with
    the target's index (and one with another index), far massless padding
    at the end, a dead stretch of blocks, an all-masked last tile, padding
    targets, leaf cells 0..7 with exempt rows (-1) and a covered stretch.
    Source indices are -1 except on the planted self pairs, so that the
    index rule and the relative-distance rule drop the same pairs.
    only_last_block: tile 0 takes sources of the last block only."""
    n = 10000
    tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
    tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int64)
    tidx[:, -5:] = n
    spos = rng.standard_normal((S, 3)).astype(np.float32)
    smass = rng.uniform(0.1, 1, S).astype(np.float32)
    sidx = np.full(S, -1, np.int64)
    k = min(8, S // 4, T)
    spos[:k] = tpos[0, :k]                    # self pairs
    sidx[:k] = tidx[0, :k]
    spos[-4:] = 1e30                          # far, massless padding
    smass[-4:] = 0.0
    mask = rng.uniform(size=(C, S)) < 0.4
    mask[0, :k] = True
    mask[:, S // 3:S // 2] = False            # a dead stretch of blocks
    if C > 1:
        mask[-1] = False                      # an all-masked tile
    if only_last_block:
        mask[0, :(S - 1) // 1024 * 1024] = False
        spos[-8:-4] = tpos[0, :4]             # coincident, in that block
        mask[0, -8:-4] = True
    tcell = rng.integers(0, 8, (C, T, 3)).astype(np.int64)
    scell = rng.integers(0, 8, (S, 3)).astype(np.int64)
    scell[:k] = tcell[0, :k]                  # the self pairs are near
    scell[S // 2:S // 2 + 20] = -1            # exempt rows
    scell[-30:-8] = 127                       # a covered stretch
    return (tpos, tidx, spos, smass, sidx, mask), (scell, tcell)


EDGE_SHAPES = ((3, 200, 3000, 0.0, False), (2, 64, 1024, 0.01, False),
               (1, 512, 70, 0.0, False), (2, 130, 2500, 0.0, True))


def mma_edge_cases(shared, dev):
    """K6 vs its plain version on made rows (row_case: S ragged, S < 128, a
    tile whose only active block is the last), with and without the cell
    test (grid_sep 2 and 3), every mode and precision. The source planted
    on target (0, 0) must add nothing there: with its mask switched off
    that target's result stays the same bit for bit. Returns the worst
    |kernel - plain| per form and precision."""
    rng = np.random.default_rng(17)
    worst = {f"{f}/{p}": 0.0 for f in ("mma", "mma_cell") for p in PRECS}
    for i, (C, T, S, eps, last) in enumerate(EDGE_SHAPES):
        row, (scell, tcell) = row_case(rng, C, T, S, last)
        args = [torch.as_tensor(a, device=dev) for a in row]
        off = args[5].clone()
        off[0, 0] = False
        if last:
            off[0, -8] = False
        cells = dict(src_cell=torch.as_tensor(scell, device=dev),
                     tgt_cell=torch.as_tensor(tcell, device=dev),
                     grid_sep=2 + i % 2)
        for form, ckw in (("mma", {}), ("mma_cell", cells)):
            for prec in PRECS:
                for mode in MODES:
                    kw = dict(mode=mode, prec=prec, **ckw)
                    got = shared.eval_shared_mma(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    want = shared.eval_shared_mma_plain(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    key = f"{form}/{prec}"
                    worst[key] = max(worst[key], compare(got, want,
                                                         **mma_tol(prec)))
                    if C > 1 and bool(got[0][-1].any() | got[1][-1].any()):
                        raise AssertionError(f"K6 {key}: the all-masked "
                                             "tile got a nonzero result")
                    bare = shared.eval_shared_mma(
                        *args[:5], off, scal(eps, 1.5, args[0]), **kw)
                    if not all(torch.equal(a[0, 0], b[0, 0])
                               for a, b in zip(got, bare)):
                        raise AssertionError(f"K6 {key} {mode}: a source on "
                                             "a target added something")
            if ckw:
                free = shared.eval_shared_mma(*args, scal(eps, 1.5, args[0]))
                if not bool((got[1] - free[1]).abs().max() > 1e-3):
                    raise AssertionError("K6: the cell test removed nothing")
    return worst


def blocks_at(shared, args, eps, span):
    """K5 at `span` twice (bit for bit) against its plain version; the
    plan its kernels build equal to fused_plan(mask, span, BLOCK). Returns
    (the kernel's result, |kernel - plain|)."""
    mask = args[5]
    if not same_plan(shared.blocks_device_plan(mask, span),
                     shared.fused_plan(mask, span, shared.BLOCK)):
        raise AssertionError(f"K5 span {span}: the kernels' plan differs "
                             "from fused_plan's")
    got = shared.eval_shared_blocks(*args, scal(eps, 1.5, args[0]), span=span)
    again = shared.eval_shared_blocks(
        *args, scal(eps, 1.5, args[0]), span=span)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K5 span {span}: two launches differ")
    want = shared.eval_shared_blocks_plain(
        *args, scal(eps, 1.5, args[0]), span=span)
    return got, compare(got, want)


def blocks_edge_cases(shared, dev):
    """K5 vs its plain version at spans 1, 2 and BLOCKS_SPAN, two launches
    bit for bit, its card plan equal to fused_plan(mask, span, BLOCK):
    on row_case's rows (S ragged, S below a block, a tile whose only
    active block is the last, self pairs, eps 0, an all-masked tile) and
    on rows made for its plan: a tile whose list holds every block of the
    row beside empty tiles, a tile whose active blocks all lie at the
    row's end, S ending inside a block whose ragged last block is a
    tile's only one, lists of 3 and 5 blocks (not multiples of the span),
    sources planted on targets with their indices, far massless padding
    inside the row, eps 0 and 0.01, T past one work item. A tile with no
    active block gets exact zeros. Returns the worst |kernel - plain|."""
    rng = np.random.default_rng(19)
    spans = sorted({1, 2, shared.BLOCKS_SPAN})
    worst = 0.0
    for C, T, S, eps, last in EDGE_SHAPES:
        row, _ = row_case(rng, C, T, S, last)
        args = [torch.as_tensor(a, device=dev) for a in row]
        for span in spans:
            got, err = blocks_at(shared, args, eps, span)
            worst = max(worst, err)
            if C > 1 and bool(got[0][-1].any() | got[1][-1].any()):
                raise AssertionError("K5: the all-masked tile got a nonzero "
                                     "result")
    B = shared.BLOCK
    C, T, nb, tail = 6, 300, 9, 300
    S = (nb - 1) * B + tail
    n = 10000
    tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
    tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int64)
    tidx[:, -3:] = n                          # padding targets
    spos = (rng.standard_normal((S, 3)) + 0.3).astype(np.float32)
    smass = rng.uniform(0.1, 1, S).astype(np.float32)
    sidx = np.full(S, -1, np.int64)
    for c in range(C):                        # self pairs in blocks 0, 4
        at = [c * 8 + k for k in range(4)] + [4 * B + c * 8 + k
                                              for k in range(4)]
        spos[at] = np.concatenate([tpos[c, :4], tpos[c, 4:8]])
        sidx[at] = np.concatenate([tidx[c, :4], tidx[c, 4:8]])
    spos[S // 2:S // 2 + 4] = 1e30            # far, massless padding
    smass[S // 2:S // 2 + 4] = 0.0
    mask = np.zeros((C, S), bool)
    mask[0] = rng.uniform(size=S) < 0.5       # every block: a long list
    mask[0, ::B] = True
    mask[0, :8] = mask[0, 4 * B:4 * B + 8] = True
    # tile 1 has no list
    mask[2, S - tail:] = True                 # only the ragged last block
    mask[3, (nb - 3) * B:] = rng.uniform(size=S - (nb - 3) * B) < 0.3
    for c, k in ((4, 3), (5, 5)):             # 3 and 5 blocks, scattered
        for b in np.sort(rng.choice(nb - 1, k, replace=False)):
            mask[c, b * B + rng.integers(0, B, 3)] = True
    mask[4, 24:32] = mask[4, 4 * B + 32:4 * B + 40] = True
    args = [torch.as_tensor(a, device=dev)
            for a in (tpos, tidx, spos, smass, sidx, mask)]
    for eps in (0.0, 0.01):
        for span in spans:
            got, err = blocks_at(shared, args, eps, span)
            worst = max(worst, err)
            if bool(got[0][1].any() | got[1][1].any()):
                raise AssertionError("K5: the tile with no list got a "
                                     "nonzero result")
    return worst


def same_plan(a, b) -> bool:
    """Two K1 plans (shared.FusedPlan) equal in every field."""
    return a.zmax == b.zmax and all(torch.equal(x, y) for x, y in
                                    zip(a[:4], b[:4]))


def k1_structure_cases(shared, dev, dtype=torch.float32, cells=False):
    """K1 against its plain version on rows made for its plan, in dtype,
    every form (with cells: the four cell forms, leaf cells 0..7 on both
    sides of grid_sep 2 and 3 and exempt rows) and mode: one tile whose
    list holds every granule of the row beside a tile with none; live
    granules scattered through the row; lists of SPAN + 1 and 2 SPAN - 1
    entries (not multiples of the span); S ending inside a granule, whose
    ragged last granule is a tile's only live one; T past one target
    group; self pairs and far padding inside the row. The plan that K1's
    kernels build must equal fused_plan's, two launches on the same inputs
    must agree bit for bit, and the tile with no list must get zeros.
    Returns the worst |kernel - plain| per form."""
    G, span = shared.GRANULE, shared.SPAN
    rng = np.random.default_rng(23)
    worst = {}
    for C, T, ng, tail, eps, sep in ((6, 300, 5 * span + 2, 37, 0.0, 2),
                                     (3, 64, 3, 5, 0.01, 3)):
        S = ng * G + tail
        n = 10000
        tpos = rng.standard_normal((C, T, 3))
        tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int64)
        tidx[:, -3:] = n                      # padding targets
        spos = rng.standard_normal((S, 3)) + 0.3
        smass = rng.uniform(0.1, 1, S)
        sidx = rng.integers(-1, n, S).astype(np.int64)
        spos[:6] = tpos[0, :6]                # self pairs
        sidx[:6] = tidx[0, :6]
        spos[S // 2:S // 2 + 4] = 1e30        # far, massless padding
        smass[S // 2:S // 2 + 4] = 0.0
        sidx[S // 2:S // 2 + 4] = -1
        mask = np.zeros((C, S), bool)
        mask[0] = rng.uniform(size=S) < 0.5   # every granule: a long list
        mask[0, ::G] = True
        # tile 1 has no list
        mask[2, S - tail:] = True             # only the ragged last one
        if C > 3:
            for g in rng.choice(ng, ng // 3, replace=False):  # scattered
                mask[3, g * G + rng.integers(0, G, 2)] = True
            for c, k in ((4, span + 1), (5, 2 * span - 1)):
                for g in np.sort(rng.choice(ng, k, replace=False)):
                    mask[c, g * G + rng.integers(0, G)] = True
        d = rng.standard_normal((S, 3)) * 0.1
        quad = np.stack([d[:, a] * d[:, b] for a, b in shared.quad_pairs(3)],
                        1) * smass[:, None]
        args = on_card((tpos, tidx, spos, smass, sidx, mask), dev, dtype)
        if not same_plan(shared.fused_device_plan(args[5]),
                         shared.fused_plan(args[5])):
            raise AssertionError("K1: the kernels' plan differs from "
                                 "fused_plan's")
        ckw = {}
        if cells:
            scell = rng.integers(0, 8, (S, 3))
            scell[S // 3:S // 3 + 20] = -1    # exempt rows
            ckw = dict(src_cell=torch.as_tensor(scell, device=dev),
                       tgt_cell=torch.as_tensor(rng.integers(0, 8, (C, T, 3)),
                                                device=dev), grid_sep=sep)
        for q in (None, on_card((quad,), dev, dtype)[0]):
            for comp in (False, True):
                form = shared.form_name(q is not None, comp, cells)
                for mode in MODES:
                    kw = dict(mode=mode, compensated=comp, src_quad=q, **ckw)
                    got = shared.eval_shared_fused(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    again = shared.eval_shared_fused(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"K1 {form} {mode}: two launches "
                                             "differ")
                    if bool(got[0][1].any() | got[1][1].any()):
                        raise AssertionError(f"K1 {form}: the tile with no "
                                             "list got a nonzero result")
                    want = shared.eval_shared_plain(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    worst[form] = max(worst.get(form, 0.0),
                                      compare(got, want, **tol(dtype)))
    return worst


def k6_structure_cases(shared, dev) -> dict:
    """K6 against its plain version on rows made for its plan (K1's), at
    each precision and cell form (none, 3-D cells, 2-D cells on 2-D
    operands) and mode: one tile whose list holds every granule of the row
    beside a tile with none; live granules scattered through the row;
    lists of SPAN + 1 and 2 SPAN - 1 entries (not multiples of the span);
    S ending inside a granule, whose ragged last granule is a tile's only
    live one; T past one work item; sources exactly on targets of tile 0;
    padding inside the row at 1e30 and at 4 * box (massless, mask on);
    each tile's targets in a unit cube, as the engine's tiles are. The
    plan that K6's kernels build must equal fused_plan's, two launches on
    the same inputs must agree bit for bit, the tile with no list must get
    zeros. Returns the worst |kernel - plain| per form and precision."""
    G, span = shared.GRANULE, shared.SPAN
    rng = np.random.default_rng(37)
    worst = {}
    for C, T, ng, tail, eps, sep in ((6, 300, 5 * span + 2, 37, 0.05, 2),
                                     (3, 64, 3, 5, 0.0, 3)):
        S = ng * G + tail
        for D, cell in ((3, ""), (3, "_cell"), (2, "_cell2d")):
            centers = rng.uniform(-2, 2, (C, 1, D))
            tpos = centers + rng.uniform(-0.5, 0.5, (C, T, D))
            tidx = rng.choice(10000, size=(C, T),
                              replace=False).astype(np.int64)
            spos = rng.uniform(-3, 3, (S, D))
            smass = rng.uniform(0.1, 1, S)
            sidx = np.full(S, -1, np.int64)
            spos[:6] = tpos[0, :6]            # on targets: dead by distance
            box = 4.0
            spos[S // 2:S // 2 + 4] = 1e30   # far, massless padding
            spos[S // 3:S // 3 + 4] = 4 * box
            smass[S // 2:S // 2 + 4] = 0.0
            smass[S // 3:S // 3 + 4] = 0.0
            mask = np.zeros((C, S), bool)
            mask[0] = rng.uniform(size=S) < 0.5   # every granule
            mask[0, ::G] = True
            mask[0, S // 2:S // 2 + 4] = True
            mask[0, S // 3:S // 3 + 4] = True
            # tile 1 has no list
            mask[2, S - tail:] = True             # only the ragged last one
            if C > 3:
                for g in rng.choice(ng, ng // 3, replace=False):
                    mask[3, g * G + rng.integers(0, G, 2)] = True
                for c, k in ((4, span + 1), (5, 2 * span - 1)):
                    for g in np.sort(rng.choice(ng, k, replace=False)):
                        mask[c, g * G + rng.integers(0, G)] = True
            args = on_card((tpos, tidx, spos, smass, sidx, mask), dev)
            if not same_plan(shared.fused_device_plan(args[5], "shared_mma"),
                             shared.fused_plan(args[5])):
                raise AssertionError("K6: the kernels' plan differs from "
                                     "fused_plan's")
            ckw = {}
            if cell:
                scell = rng.integers(0, 8, (S, D))
                scell[S // 4:S // 4 + 20] = -1    # exempt rows
                ckw = dict(src_cell=torch.as_tensor(scell, device=dev),
                           tgt_cell=torch.as_tensor(
                               rng.integers(0, 8, (C, T, D)), device=dev),
                           grid_sep=sep)
            for prec in PRECS:
                key = f"mma{cell}/{prec}"
                for mode in MODES:
                    kw = dict(mode=mode, prec=prec, **ckw)
                    got = shared.eval_shared_mma(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    again = shared.eval_shared_mma(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"K6 {key} {mode}: two launches "
                                             "differ")
                    if bool(got[0][1].any() | got[1][1].any()):
                        raise AssertionError(f"K6 {key}: the tile with no "
                                             "list got a nonzero result")
                    want = shared.eval_shared_mma_plain(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    worst[key] = max(worst.get(key, 0.0),
                                     compare(got, want, **mma_tol(prec)))
    return worst


def edge_cases(shared, dev, dtype=torch.float32):
    """Kernel vs plain on small cases that hit every branch of the kernel,
    in every form, in dtype (the float64 build with float64); the
    cancellation check in float32 (float64 has staircase()). Returns the
    worst |kernel - plain| per form and the cancellation errors."""
    rng = np.random.default_rng(7)
    worst = {f: 0.0 for f in shared.FORMS
             if f.startswith(("mono", "quad")) and not f.endswith("_cell")}

    def check(args, eps, quad=None, empty_tile=False):
        for comp in (False, True):
            form = ("quad" if quad is not None else "mono") \
                + ("_comp" if comp else "")
            for mode in ("both", "acc", "pot"):
                kw = dict(mode=mode, compensated=comp, src_quad=quad)
                got = shared.eval_shared_fused(
                    *args, scal(eps, 1.5, args[0]), **kw)
                want = shared.eval_shared_plain(
                    *args, scal(eps, 1.5, args[0]), **kw)
                worst[form] = max(worst[form],
                                  compare(got, want, **tol(dtype)))
                if empty_tile and bool(got[0][-1].any() | got[1][-1].any()):
                    raise AssertionError(f"{form}: empty tile got a "
                                         "nonzero result")

    for C, T, S, eps in ((3, 200, 3000, 0.0), (2, 64, 1024, 0.01),
                         (1, 512, 70, 0.0)):
        n = 10000
        tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
        tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int64)
        tidx[:, -5:] = n                      # padding targets
        spos = rng.standard_normal((S, 3)).astype(np.float32)
        smass = rng.uniform(0.1, 1, S).astype(np.float32)
        sidx = rng.integers(-1, n, S).astype(np.int64)
        k = min(8, S, T)
        spos[:k] = tpos[0, :k]                # self pairs, excluded by index
        sidx[:k] = tidx[0, :k]
        spos[k:2 * k] = tpos[0, :k]           # coincident, other index
        spos[-4:] = 1e30                      # far, massless padding
        smass[-4:] = 0.0
        sidx[-4:] = -1
        mask = rng.uniform(size=(C, S)) < 0.4
        mask[:, S // 3:S // 2] = False        # a dead stretch of blocks
        if C > 1:
            mask[-1] = False                  # an empty tile
        args = on_card((tpos, tidx, spos, smass, sidx, mask), dev, dtype)
        check(args, eps, empty_tile=C > 1)

    # node rows with second moments Q = m d d^T: ragged S, a dead stretch,
    # an empty tile, and a masked-out node 1e-9 from a target at eps = 0,
    # where inv_r^5 overflows fp32 (the result must stay finite)
    for C, T, S in ((3, 200, 2500), (2, 130, 700)):
        tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
        tidx = rng.choice(10000, size=(C, T), replace=False).astype(np.int64)
        spos = (1.5 + rng.standard_normal((S, 3))).astype(np.float32)
        smass = rng.uniform(0.1, 1, S).astype(np.float32)
        sidx = np.full(S, -1, np.int64)
        d = rng.standard_normal((S, 3)) * 0.1
        quad = (np.stack([d[:, a] * d[:, b] for a, b in shared.quad_pairs(3)],
                         1) * smass[:, None]).astype(np.float32)
        mask = rng.uniform(size=(C, S)) < 0.4
        mask[:, S // 3:S // 2] = False
        mask[-1] = False
        tpos[0, 3] = (1e-3, -2e-3, 5e-4)
        spos[7] = tpos[0, 3] + np.float32(1e-9)
        mask[0, 7] = False
        args = on_card((tpos, tidx, spos, smass, sidx, mask), dev, dtype)
        check(args, 0.0, quad=on_card((quad,), dev, dtype)[0],
              empty_tile=True)
    for form, err in k1_structure_cases(shared, dev, dtype).items():
        worst[form] = max(worst[form], err)
    if dtype != torch.float32:
        return worst, staircase(dev, dtype, "K1")

    # a long, cancellation-heavy row (far shell, masses over seven
    # decades, 64 source blocks): TwoSum must beat fp32; the kernel sums in
    # a fixed order, so an equal error means it ran fp32 sums
    C, T, S = 1, 8, 65536
    tpos = (rng.standard_normal((C, T, 3)) * 0.01).astype(np.float32)
    dirs = rng.standard_normal((S, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    src = dirs * rng.uniform(5.0, 50.0, (S, 1))
    mass = rng.uniform(1e-6, 10.0, S)
    dd = src[None, None] - tpos.astype(np.float64)[:, :, None]
    pot_ref = -(mass[None, None] / np.linalg.norm(dd, axis=-1)).sum(-1)
    args = [torch.as_tensor(a, device=dev) for a in
            (tpos, np.arange(T, dtype=np.int64)[None],
             src.astype(np.float32), mass.astype(np.float32),
             np.full(S, -1, np.int64), np.ones((C, S), bool))]
    check(args, 0.0)
    errs = {}
    for comp in (False, True):
        _, p = shared.eval_shared_fused(
            *args, scal(0.0, 1.0, args[0]), mode="pot", compensated=comp)
        errs[comp] = float(np.abs(p.double().cpu().numpy() - pot_ref).max())
    if not errs[True] < errs[False]:
        raise AssertionError(f"compensated error {errs[True]:.3e} >= fp32 "
                             f"error {errs[False]:.3e}")
    return worst, {"fp32": errs[False], "compensated": errs[True]}


def cell_edge_cases(shared, dev, dtype=torch.float32):
    """K1c vs plain on small cases, every form and mode: random leaf cells
    on both sides of grid_sep 2 and 3, exempt rows (cell -1), self pairs
    that are covered too, a stretch of sources all covered, ragged T and
    S, an empty tile, int32 and int64 cells, and in the quadrupole forms a
    masked-out node 1e-9 from a target at eps = 0. Returns the worst
    |kernel - plain| per form."""
    rng = np.random.default_rng(13)
    worst = {f: 0.0 for f in shared.FORMS
             if f.startswith(("mono", "quad")) and f.endswith("_cell")}
    for C, T, S, sep, eps, itype in (
            (3, 200, 3000, 2, 0.0, np.int64), (2, 130, 1100, 3, 0.01,
                                               np.int32),
            (2, 512, 70, 3, 0.0, np.int64)):
        tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
        tidx = rng.choice(10000, size=(C, T), replace=False).astype(np.int64)
        tidx[:, -5:] = 10000                  # padding targets
        spos = (0.5 + rng.standard_normal((S, 3))).astype(np.float32)
        smass = rng.uniform(0.1, 1, S).astype(np.float32)
        sidx = rng.integers(-1, 10000, S).astype(np.int64)
        tcell = rng.integers(0, 8, (C, T, 3)).astype(itype)
        scell = rng.integers(0, 8, (S, 3)).astype(itype)
        k = min(8, S // 4, T)
        spos[:k] = tpos[0, :k]                # self pairs ...
        sidx[:k] = tidx[0, :k]
        scell[:k // 2] = (tcell[0, :k // 2] + 5) % 8   # ... covered too
        scell[k // 2:k] = tcell[0, k // 2:k]
        scell[S // 2:S // 2 + 20] = -1        # exempt rows
        scell[-30:] = 127                     # a covered stretch
        d = rng.standard_normal((S, 3)) * 0.1
        quad = (np.stack([d[:, a] * d[:, b] for a, b in shared.quad_pairs(3)],
                         1) * smass[:, None]).astype(np.float32)
        mask = rng.uniform(size=(C, S)) < 0.5
        mask[:, S // 3:S // 2] = False        # a dead stretch
        mask[-1] = False                      # an empty tile
        tpos[0, 9] = (1e-3, -2e-3, 5e-4)      # a masked-out node on a target
        spos[S // 4] = tpos[0, 9] + np.float32(1e-9)
        scell[S // 4] = tcell[0, 9]
        mask[0, S // 4] = False
        args = on_card((tpos, tidx, spos, smass, sidx, mask), dev, dtype)
        ckw = dict(src_cell=torch.as_tensor(scell, device=dev),
                   tgt_cell=torch.as_tensor(tcell, device=dev), grid_sep=sep)
        for q in (None, on_card((quad,), dev, dtype)[0]):
            for comp in (False, True):
                form = shared.form_name(q is not None, comp, True)
                for mode in MODES:
                    kw = dict(mode=mode, compensated=comp, src_quad=q, **ckw)
                    got = shared.eval_shared_fused(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    want = shared.eval_shared_plain(
                        *args, scal(eps, 1.5, args[0]), **kw)
                    worst[form] = max(worst[form],
                                      compare(got, want, **tol(dtype)))
                    if bool(got[0][-1].any() | got[1][-1].any()):
                        raise AssertionError(f"{form}: empty tile got a "
                                             "nonzero result")
                    free = shared.eval_shared_fused(
                        *args, scal(eps, 1.5, args[0]), mode=mode,
                        compensated=comp, src_quad=q)
                    k = 1 if mode == "pot" else 0
                    if not bool((got[k] - free[k]).abs().max() > 1e-3):
                        raise AssertionError(f"{form}: the cell test "
                                             "removed nothing")
    for form, err in k1_structure_cases(shared, dev, dtype, True).items():
        worst[form] = max(worst[form], err)
    return worst


def wide_cell_cases(shared, dev) -> dict:
    """K1c's four forms and K6 with cells (x3) against their plain versions
    on cells that fill the packed fields: D = 2 and 3, leaf coordinates up
    to 2^CELL_BITS[D] - 1 (13 and 8 bits, past grid2's level caps of 10
    and 7) with target clusters at both ends of the range, each source's
    cell within sep + 1 of some target's, exempt rows, grid_sep 2, 5 and
    2^CELL_BITS[D]; at 2 and 5 the cell test must remove pairs. eps 0.05
    (0.25 for K6), so that no near-coincident pair of the made rows
    dominates the tolerance. Returns the worst |kernel - plain| per D and
    form."""
    rng = np.random.default_rng(29)
    C, T, S = 2, 160, 2100
    worst = {}
    for D in (2, 3):
        top = 1 << shared.CELL_BITS[D]
        for sep in (2, 5, top):
            tpos = rng.standard_normal((C, T, D)).astype(np.float32)
            tidx = rng.choice(10000, size=(C, T),
                              replace=False).astype(np.int64)
            spos = (0.5 + rng.standard_normal((S, D))).astype(np.float32)
            smass = rng.uniform(0.1, 1, S).astype(np.float32)
            sidx = np.full(S, -1, np.int64)
            centers = rng.integers(0, top, (C, 4, D))
            centers[0, 0], centers[0, 1] = 0, top - 1
            tcell = np.clip(centers[np.arange(C)[:, None],
                                    rng.integers(0, 4, (C, T))]
                            + rng.integers(-2, 3, (C, T, D)), 0, top - 1)
            near = tcell[rng.integers(0, C, S), rng.integers(0, T, S)]
            scell = np.clip(near + rng.integers(-sep - 1, sep + 2, (S, D)),
                            0, top - 1)
            scell[-40:] = rng.integers(0, top, (40, D))
            scell[S // 2:S // 2 + 20] = -1    # exempt rows
            d = rng.standard_normal((S, D)) * 0.1
            quad = (np.stack([d[:, a] * d[:, b]
                              for a, b in shared.quad_pairs(D)], 1)
                    * smass[:, None]).astype(np.float32)
            mask = rng.uniform(size=(C, S)) < 0.6
            args = on_card((tpos, tidx, spos, smass, sidx, mask), dev)
            ckw = dict(src_cell=torch.as_tensor(scell, device=dev),
                       tgt_cell=torch.as_tensor(tcell, device=dev),
                       grid_sep=sep)
            for q in (None, on_card((quad,), dev)[0]):
                for comp in (False, True):
                    form = shared.form_name(q is not None, comp, True)
                    kw = dict(compensated=comp, src_quad=q, **ckw)
                    got = shared.eval_shared_fused(
                        *args, scal(0.05, 1.5, args[0]), **kw)
                    want = shared.eval_shared_plain(
                        *args, scal(0.05, 1.5, args[0]), **kw)
                    key = f"{D}d/{form}"
                    worst[key] = max(worst.get(key, 0.0), compare(got, want))
                    free = shared.eval_shared_fused(
                        *args, scal(0.05, 1.5, args[0]), compensated=comp,
                        src_quad=q)
                    if sep < top and not bool(
                            (got[1] - free[1]).abs().max() > 1e-3):
                        raise AssertionError(f"{key} sep {sep}: the cell "
                                             "test removed nothing")
            kw = dict(prec="x3", **ckw)
            got = shared.eval_shared_mma(*args, scal(0.25, 1.5, args[0]), **kw)
            want = shared.eval_shared_mma_plain(
                *args, scal(0.25, 1.5, args[0]), **kw)
            key = f"{D}d/mma_cell"
            worst[key] = max(worst.get(key, 0.0),
                             compare(got, want, **mma_tol("x3")))
    return worst


def surviving_pairs(inputs, cells, n):
    """Pairs (real target, mask-true source) that K1c's cell test leaves
    alive, counted in source blocks of 1024."""
    tidx, mask = inputs[1], inputs[5]
    src_cell, tgt_cell, sep = cells
    real = (tidx < n)[:, :, None]
    tc = tgt_cell.to(torch.int32)
    total = 0
    for s0 in range(0, mask.shape[1], 1024):
        sc = src_cell[s0:s0 + 1024].to(torch.int32)
        csep = (sc[None, None, :, 0] - tc[:, :, None, 0]).abs()
        for d in (1, 2):
            csep = torch.maximum(
                csep, (sc[None, None, :, d] - tc[:, :, None, d]).abs())
        alive = (csep < sep) | (sc[None, None, :, 0] < 0)
        total += int((alive & mask[:, None, s0:s0 + 1024] & real).sum())
    return total


def bound(inputs, n, quad=False, comp=False, cells=None, per_pair=None,
          extra_bytes=0, tensor_flops=0):
    """(bound_ms, bound_by): the least time the card could take for one
    call at these inputs, the larger of the bytes it must move (each input
    read once, each output written once) over the HBM rate and the
    operations its live pairs (mask-true sources x real targets of the
    n-particle tree, and TwoSum per staged granule and span) need over the
    fp32 peak (fp64 for float64 operands). cells (src_cell, tgt_cell,
    grid_sep) for K1c: the two cell tensors are read too, every mask-true
    pair costs the OPS_CELL operations of the cell test, and only the
    pairs the test leaves alive cost the 20 (64) fp32 operations. per_pair replaces the 20 (K6: 13);
    extra_bytes are added (K5: its scratch, written and read);
    tensor_flops a surviving pair run at the bf16 tensor-core peak (K6)
    and bound the call if that takes longest, reported as operations."""
    tpos, tidx, spos, smass, sidx, mask = inputs[:6]
    C, T, _ = tpos.shape
    nbytes = sum(t.numel() * t.element_size() for t in inputs[:6]
                 + ((inputs[6],) if quad else ())
                 + (tuple(cells[:2]) if cells else ()))
    nbytes += C * T * 4 * tpos.element_size() + extra_bytes  # acc, pot
    ntgt = (tidx < n).sum(1).double()          # padding targets carry n
    pairs = float((mask.sum(1).double() * ntgt).sum())
    if per_pair is None:
        per_pair = FLOPS_QUAD if quad else FLOPS_MONO
    alive = surviving_pairs(inputs, cells, n) if cells else pairs
    flops = alive * per_pair + (pairs * OPS_CELL if cells else 0)
    if comp:
        from rakau_tpu_torch.kernels import shared
        cnt = shared.fused_plan(mask).cnt.double()
        flops += FLOPS_TWOSUM * float(
            ((cnt + (cnt / shared.SPAN).ceil()) * ntgt).sum())
    t_bytes = nbytes / PEAK_BYTES
    peak = PEAK_FP64 if tpos.dtype == torch.float64 else PEAK_FP32
    t_ops = max(flops / peak, alive * tensor_flops / PEAK_BF16)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                        else "operations")


def pool_case(rng, T, block, sched, wb=4, pad=40.0, n=10000):
    """A synthetic pool of len(sched) tiles over two windows of wb blocks:
    node blocks first (second moments Q = m d d^T, idx -1), then particle
    blocks, each segment ending in padding rows (mass 0, idx -1, at `pad`:
    the 4 * box sentinel or 1e30), the rows no tile visits padding too;
    self pairs (a particle row that is a target of its tile) and a node
    row exactly on a target in tile 0; the last 5 targets of each tile
    are padding (index n)."""
    from rakau_tpu_torch.kernels.shared import quad_pairs
    G = len(sched)
    window = wb * block
    P = 2 * window
    tpos = rng.standard_normal((G, T, 3)).astype(np.float32)
    tidx = rng.choice(n, size=(G, T), replace=False).astype(np.int64)
    tidx[:, -5:] = n
    ppos = np.full((P, 3), pad, np.float32)
    pmass = np.zeros(P, np.float32)
    pidx = np.full(P, -1, np.int64)
    pquad = np.zeros((P, 6), np.float32)
    for g, (w, s, m, p) in enumerate(sched):
        r0 = (w * wb + s) * block
        for seg, nb in ((0, m), (1, p)):
            rows = np.arange(r0, r0 + nb * block)[:max(0, nb * block - 7)]
            r0 += nb * block
            ppos[rows] = (1.5 * rng.standard_normal((len(rows), 3))
                          ).astype(np.float32)
            pmass[rows] = rng.uniform(0.1, 1, len(rows))
            if seg == 0:
                d = rng.standard_normal((len(rows), 3)) * 0.1
                pquad[rows] = np.stack([d[:, a] * d[:, b] for a, b in
                                        quad_pairs(3)], 1) \
                    * pmass[rows, None]
            elif len(rows) > 4:
                pidx[rows] = rng.choice(n, len(rows), replace=False)
                k = rows[:4]                  # self pairs
                pidx[k] = tidx[g, :4]
                ppos[k] = tpos[g, :4]
    w, s, m, _ = sched[0]
    ppos[(w * wb + s) * block + 1] = tpos[0, 7]   # node row on a target
    return ([torch.as_tensor(a) for a in (tpos, tidx, ppos, pmass, pidx,
                                          np.asarray(sched, np.int64))],
            window, torch.as_tensor(pquad))


def same_rows_plan(a, b) -> bool:
    """Two plans of K2 or K3 (rows.RowsPlan) equal in every field."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


# (window, start block, node blocks, particle blocks); tile 3 is empty
POOL_SCHED = [[0, 0, 1, 2], [0, 3, 0, 1], [1, 0, 2, 1], [0, 0, 0, 0],
              [1, 3, 1, 0]]
# one segment of 36 blocks beside segments of 1-2 (windows of 40 blocks)
POOL_SCHED_LONG = [[0, 0, 6, 30], [0, 36, 0, 1], [1, 0, 1, 1], [0, 0, 0, 0],
                   [1, 2, 0, 2], [1, 4, 2, 0]]
# (T, pool block, eps, blocks a window, padding, schedule, dimensions):
# pool blocks of 128, 512 and 200 (not a multiple of the granule), ragged
# T, the padding at the 4 * box sentinel and at 1e30, a segment far longer
# than the rest, and 2-D operands (padded to 3-D by the wrapper)
POOL_EDGE = ((300, 128, 0.0, 4, 40.0, POOL_SCHED, (3,)),
             (77, 512, 0.0, 4, 1e30, POOL_SCHED, (3, 2)),
             (512, 128, 0.01, 4, 40.0, POOL_SCHED, (3,)),
             (256, 512, 0.0, 4, 40.0, POOL_SCHED, (3,)),
             (200, 200, 0.0, 4, 1e30, POOL_SCHED, (3, 2)),
             (130, 128, 0.0, 40, 40.0, POOL_SCHED_LONG, (3,)))


def pool_2d(args, quad):
    """A pool case's operands in 2-D: x and y of the positions, and the
    xx, xy, yy second moments (quad_pairs(2)'s columns of quad_pairs(3))."""
    from rakau_tpu_torch.kernels.shared import quad_pairs
    cols = [quad_pairs(3).index(p) for p in quad_pairs(2)]
    out = list(args)
    out[0] = args[0][..., :2].contiguous()
    out[2] = args[2][:, :2].contiguous()
    return out, quad[:, cols].contiguous()


def pool_forms(args, quad, window, eps, block, dtype, worst):
    """K2 vs plain on one synthetic pool in every form and mode: two
    launches bit for bit equal, the empty tile (3) zeros; the worst
    |kernel - plain| of each form into `worst`."""
    from rakau_tpu_torch.kernels import pool
    for q in (None, quad):
        for comp in (False, True):
            form = pool._form(q is not None, comp)
            for mode in MODES:
                kw = dict(compensated=comp, mode=mode, pool_quad=q)
                got = pool.eval_pool_fused(
                    *args, window, scal(eps, 1.5, args[0]), block, **kw)
                again = pool.eval_pool_fused(
                    *args, window, scal(eps, 1.5, args[0]), block, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"K2 {form} {mode}: two launches "
                                         "differ")
                want = pool.eval_pool_plain(
                    *args, window, scal(eps, 1.5, args[0]), block, **kw)
                worst[form] = max(worst[form],
                                  compare(got, want, **tol(dtype)))
                if bool(got[0][3].any() | got[1][3].any()):
                    raise AssertionError(f"K2 {form}: the empty tile got a "
                                         "nonzero result")


def pool_edge_cases(dev, dtype=torch.float32):
    """K2 vs plain on synthetic pools that hit every branch of the kernel
    and of its plan (POOL_EDGE, 3-D and 2-D), in every form and mode, in
    dtype (pool_forms): the plan K2's kernel builds must equal
    pool_plan's, two launches must agree bit for bit, the empty tile must
    get zeros; then the cancellation check (in float64 the staircase).
    Returns the worst |kernel - plain| per form and the cancellation
    errors."""
    from rakau_tpu_torch.kernels import pool
    rng = np.random.default_rng(11)
    worst = dict.fromkeys(pool.FORMS, 0.0)
    for T, block, eps, wb, pad, sched, dims in POOL_EDGE:
        args3, window, quad3 = pool_case(rng, T, block, sched, wb, pad)
        args3 = [a.to(dev, dtype) if a.is_floating_point() else a.to(dev)
                 for a in args3]
        quad3 = quad3.to(dev, dtype)
        P = args3[2].shape[0]
        if not same_rows_plan(pool.pool_device_plan(args3[5], window, block,
                                                    P),
                              pool.pool_plan(args3[5], window, block, P)):
            raise AssertionError("K2: the kernel's plan differs from "
                                 "pool_plan's")
        for d in dims:
            args, quad = ((args3, quad3) if d == 3
                          else pool_2d(args3, quad3))
            pool_forms(args, quad, window, eps, block, dtype, worst)
    if dtype != torch.float32:
        return worst, staircase(dev, dtype, "K2")
    # one tile of 64 blocks of a cancellation-heavy shell (masses over
    # seven decades); the quadrupole forms take it as node blocks with
    # zero second moments. TwoSum must beat fp32: the kernel sums in a
    # fixed order, so an equal error means it ran fp32 sums
    T, block, nb = 8, 512, 64
    P = nb * block
    tpos = (rng.standard_normal((1, T, 3)) * 0.01).astype(np.float32)
    dirs = rng.standard_normal((P, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    src = dirs * rng.uniform(5.0, 50.0, (P, 1))
    mass = rng.uniform(1e-6, 10.0, P)
    dd = src[None, None] - tpos.astype(np.float64)[:, :, None]
    pot_ref = -(mass[None, None] / np.linalg.norm(dd, axis=-1)).sum(-1)
    args = [torch.as_tensor(a, device=dev) for a in
            (tpos, np.arange(T, dtype=np.int64)[None],
             src.astype(np.float32), mass.astype(np.float32),
             np.full(P, -1, np.int64))]
    errs = {}
    for quad in (False, True):
        s = torch.tensor([[0, 0, nb, 0] if quad else [0, 0, 0, nb]],
                         device=dev)
        q = torch.zeros((P, 6), device=dev) if quad else None
        for comp in (False, True):
            form = pool._form(quad, comp)
            kw = dict(compensated=comp, pool_quad=q)
            for mode in MODES:
                got = pool.eval_pool_fused(
                    *args, s, P, scal(0.0, 1.0, args[0]), block, mode=mode,
                    **kw)
                want = pool.eval_pool_plain(
                    *args, s, P, scal(0.0, 1.0, args[0]), block, mode=mode,
                    **kw)
                worst[form] = max(worst[form], compare(got, want))
                if mode == "pot":
                    errs[form] = float(np.abs(
                        got[1].double().cpu().numpy() - pot_ref).max())
    for f in ("mono", "quad"):
        if not errs[f + "_comp"] < errs[f]:
            raise AssertionError(f"K2 {f}: compensated error "
                                 f"{errs[f + '_comp']:.3e} >= fp32 error "
                                 f"{errs[f]:.3e}")
    return worst, errs


def pool_segments(inputs, n: int, window: int, block: int) -> dict:
    """Blocks per real tile (min / median / max / mean) of a pool's
    schedule, node and particle segments apart."""
    tidx, sched = inputs[1], inputs[5].long()
    s = sched[tidx[:, 0] < n].double()
    out = {"tiles": int(s.shape[0]), "window": window, "block": block,
           "rows": int((s[:, 2] + s[:, 3]).sum()) * block}
    for key, v in (("blocks", s[:, 2] + s[:, 3]), ("node_blocks", s[:, 2]),
                   ("particle_blocks", s[:, 3])):
        out[key] = {"min": float(v.min()), "median": float(v.median()),
                    "max": float(v.max()), "mean": float(v.mean())}
    return out


def pool_bound(inputs, n: int, window: int, block: int, quad: bool,
               comp: bool):
    """(bound_ms, bound_by) of one K2 call: the larger of the bytes it must
    move (each tile's own segment of pool rows read once, with the second
    moments on node rows for the quadrupole; targets, indices and the
    schedule read once; outputs written once) over the HBM rate, and the
    operations its live pairs need over the fp32 (fp64) peak: real
    targets x rows with mass > 0 of the tile's segment (self pairs, at
    most one a target, are counted), x 64 on node rows with the
    quadrupole and 20 otherwise, and TwoSum per target and granule and
    per target and span (pool.pool_plan's)."""
    from rakau_tpu_torch.kernels import pool
    tpos, tidx, ppos, pmass, pidx, sched, pquad = inputs
    G, T, _ = tpos.shape
    s = sched.long()
    base = (s[:, 0] * (window // block) + s[:, 1]) * block
    mid = base + s[:, 2] * block
    end = mid + s[:, 3] * block
    live = torch.nn.functional.pad(torch.cumsum((pmass > 0).long(), 0),
                                   (1, 0))
    ntgt = (tidx < n).sum(1)
    row_bytes = (ppos.element_size() * 3 + pmass.element_size()
                 + pidx.element_size())
    nbytes = int((end - base).sum()) * row_bytes
    if quad:
        nbytes += int((mid - base).sum()) * 6 * pquad.element_size()
    nbytes += (tpos.numel() * tpos.element_size()
               + tidx.numel() * tidx.element_size()
               + sched.numel() * sched.element_size()
               + G * T * 4 * tpos.element_size())
    node = float((ntgt * (live[mid] - live[base])).sum())
    part = float((ntgt * (live[end] - live[mid])).sum())
    flops = node * (FLOPS_QUAD if quad else FLOPS_MONO) + part * FLOPS_MONO
    if comp:
        ngran = (s[:, 2] + s[:, 3]) * pool.granules_per_block(block)
        nspan = -(-ngran // pool.form_span(quad))
        flops += FLOPS_TWOSUM * float((ntgt * (ngran + nspan)).sum())
    peak = PEAK_FP64 if tpos.dtype == torch.float64 else PEAK_FP32
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                        else "operations")


def plain_pool(inputs, tiles, window, block, **kw):
    """The plain K2 version on the given tiles of a query's pool, run over
    PLAIN_TILES tiles at a time (each tile's sum depends on its own
    targets and segment only)."""
    from rakau_tpu_torch.kernels import pool
    tpos, tidx, ppos, pmass, pidx, sched, pquad = inputs
    if not kw.pop("quad"):
        pquad = None
    accs, pots = [], []
    for c in tiles.split(PLAIN_TILES):
        a, p = pool.eval_pool_plain(
            tpos[c], tidx[c], ppos, pmass, pidx, sched[c], window,
            scal(0.0, 1.0, tpos[c]), block, pool_quad=pquad, **kw)
        accs.append(a)
        pots.append(p)
    return torch.cat(accs), torch.cat(pots)


def pool_shape(inputs, window: int, block: int, quad: bool, comp: bool,
               mode: str = "both") -> dict:
    """K2's launch shape on a pool: the granules and spans of its plan
    (pool.pool_plan), its work items, the CUDA blocks of its persistent
    grid, the blocks of this form that fit an SM, the warps an SM holds on
    average (4 a block, over the blocks that find an item) and the
    registers of the form's kernel (ptxas, build phase)."""
    from rakau_tpu_torch.kernels import pool, shared
    tpos, sched = inputs[0], inputs[5]
    T, P = tpos.shape[1], int(inputs[2].shape[0])
    f64 = tpos.dtype == torch.float64
    lib = shared._library("pool", f64)
    span = pool.form_span(quad)
    plan = pool.pool_plan(sched, window, block, P, span)
    sms = shared.multiprocessors(tpos.device)
    m, c, q = MODES.index(mode), int(comp), int(quad)
    grid = lib.rakau_pool_grid(plan.work.shape[0], T, m, c, q, sms)
    items = int(plan.n_work[0]) * -(-T // (
        128 * lib.rakau_pool_targets_per_thread()))
    granules = pool.pool_granules(sched, window, block, P).clamp(min=0)
    return dict(granules=int(granules.sum()), span=span,
                spans=int(plan.n_work[0]), work_items=items,
                cuda_blocks=grid,
                blocks_per_sm_fit=lib.rakau_pool_blocks_per_sm(m, c, q),
                warps_per_sm=4 * min(grid, items) / sms, sms=sms,
                registers=REGISTERS.get("pool_f64" if f64 else "pool", {})
                .get(f"pool_kernel<{m},{c},{q}>"))


def pool_kernels(inputs, n: int, window: int, block: int, forms) -> dict:
    """K2 against its plain version on a query's real pool, per form: mode
    "both" on every tile (plain run in groups of PLAIN_TILES, timed once
    after one warm-up group), "acc" and "pot" on SUBSET_TILES tiles spread
    over the real ones; the kernel timed over the whole pool, two launches
    bit for bit equal, the card's plan equal to pool_plan's. Returns per
    form (worst error, ms, plain_ms, bound_ms, bound_by), the modes and
    the launch shape."""
    from rakau_tpu_torch.kernels import pool
    G = inputs[0].shape[0]
    dev = inputs[0].device
    every = torch.arange(G, device=dev)
    real = torch.nonzero(inputs[1][:, 0] < n).squeeze(1)
    subset = real[torch.linspace(0, len(real) - 1, min(SUBSET_TILES,
                                                       len(real)),
                                 device=dev).long()]
    P = int(inputs[2].shape[0])
    if not same_rows_plan(pool.pool_device_plan(inputs[5], window, block, P),
                          pool.pool_plan(inputs[5], window, block, P)):
        raise AssertionError("K2: the kernel's plan differs from pool_plan's"
                             " on the query's pool")
    out = {}
    for form in forms:
        quad, comp = form.startswith("quad"), form.endswith("comp")
        kw = dict(compensated=comp,
                  pool_quad=inputs[6] if quad else None)
        modes = {}
        for mode in MODES:
            got = pool.eval_pool_fused(
                *inputs[:6], window, scal(0.0, 1.0, inputs[0]), block,
                mode=mode, **kw)
            again = pool.eval_pool_fused(
                *inputs[:6], window, scal(0.0, 1.0, inputs[0]), block,
                mode=mode, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K2 {form} {mode}: two launches "
                                     "differ on the query's pool")
            del again
            pkw = dict(compensated=comp, mode=mode, quad=quad)
            if mode == "both":
                plain_pool(inputs, subset[:PLAIN_TILES], window, block,
                           **pkw)
                want, pm = synced_ms(lambda: plain_pool(
                    inputs, every, window, block, **pkw))
                err = compare(got, want)
            else:
                pm = None
                want = plain_pool(inputs, subset, window, block, **pkw)
                err = compare((got[0][subset], got[1][subset]), want)
            km = cuda_ms(lambda: pool.eval_pool_fused(
                *inputs[:6], window, scal(0.0, 1.0, inputs[0]), block,
                mode=mode, **kw), 10)
            modes[mode] = {"ms": km, "plain_ms": pm, "max_abs_err": err}
        b_ms, b_by = pool_bound(inputs, n, window, block, quad, comp)
        out[form] = dict(max_abs_err=max(v["max_abs_err"]
                                         for v in modes.values()),
                         ms=modes["both"]["ms"],
                         plain_ms=modes["both"]["plain_ms"],
                         bound_ms=b_ms, bound_by=b_by, modes=modes,
                         shape=pool_shape(inputs, window, block, quad, comp),
                         pct_of_bound=100 * b_ms / modes["both"]["ms"])
    return out


def sampled_errors(acc, pot, acc_o, pot_o, samp, dev) -> dict:
    """Force and potential RMS and largest relative errors at the sampled
    targets (acc may be None: its entries are then None)."""
    idx = torch.as_tensor(samp, device=dev)
    p = pot[idx].double().cpu().numpy()
    p_rel = np.abs(p - pot_o) / np.abs(pot_o)
    out = dict(force_rms=None, pot_rms=float(np.sqrt(np.mean(p_rel ** 2))),
               force_max=None, pot_max=float(p_rel.max()))
    if acc is not None:
        a = acc[idx].double().cpu().numpy()
        f_rel = (np.linalg.norm(a - acc_o, axis=1)
                 / np.linalg.norm(acc_o, axis=1))
        out.update(force_rms=float(np.sqrt(np.mean(f_rel ** 2))),
                   force_max=float(f_rel.max()))
    return out


def sampled_rms(acc, pot, acc_o, pot_o, samp, dev):
    """RMS relative force and potential errors at the sampled targets
    (acc may be None)."""
    e = sampled_errors(acc, pot, acc_o, pot_o, samp, dev)
    return e["force_rms"], e["pot_rms"]


def synced_ms(fn):
    """(fn(), wall ms) with device syncs before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn):
    """(fn(), device ms between CUDA events recorded around the call)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def counted(fn):
    """(fn(), launches per kernel form of K1 (with K5, K6), K2 and the
    tile kernels K3/K4 ("tiles")) that ran in the call, by bookkeeping:
    with every count and the graph cache's tally set to 0 just before the
    call and read just after, the wrappers' counts (the launches they made
    eagerly and those a capture recorded) less what the captures recorded
    plus what the graphs' replays repeated (graphs.GraphCache). measured()
    holds these against the card's profile."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import pool, shared, tiles
    shared.reset_launches()
    pool.reset_launches()
    tiles.reset_launches()
    engine._GRAPHS.reset_tally()
    out = fn()
    counts = {}
    for key, c, cap, rep in zip(
            ("K1", "K2", "tiles"), (shared.launches, pool.launches,
                                    tiles.launches),
            engine._GRAPHS.captured, engine._GRAPHS.replayed):
        counts[key] = {f: v - cap.get(f, 0) + rep.get(f, 0)
                       for f, v in c.items()}
    return out, counts


# The main kernel of each hand-written launch (one a wrapper call), by its
# name in the card's profile: its module key in counted's counts and its
# form from the kernel's template arguments (shared_fused_kernel<MODE,
# COMP, QUAD, CELL>, shared_mma_kernel<MODE, CELL, PREC>, pool_kernel<MODE,
# COMP, QUAD>).
MAIN_KERNELS = {
    "shared_fused_kernel": ("K1", 4, lambda a: (
        ("quad" if a[2] else "mono") + ("_comp" if a[1] else "")
        + ("_cell" if a[3] else ""))),
    "shared_mma_kernel": ("K1", 3, lambda a: "mma_cell" if a[1] else "mma"),
    "shared_blocks_kernel": ("K1", 0, lambda a: "blocks"),
    "pool_kernel": ("K2", 3, lambda a: (
        ("quad" if a[2] else "mono") + ("_comp" if a[1] else ""))),
    "tiles_fused_kernel": ("tiles", 0, lambda a: "fused"),
    "tiles_pairwise_kernel": ("tiles", 0, lambda a: "split"),
}
# counts that no kernel's name shows: 2-D operands padded to 3-D ("d2"),
# the float64 build ("f64") and the plain M2P row of the lists
# quadrupole ("xla_quad", no kernel)
BOOKED_ONLY = ("d2", "f64", "xla_quad")
_MAIN_RE = re.compile(r"(?<!\w)(" + "|".join(MAIN_KERNELS)
                      + r")(?:<([^()]*)>)?(?=\(|$)")


def kernel_form(name: str):
    """(module key, form) of the kernel that a device record of the
    profiler names, where it is the main kernel of a hand-written launch
    (MAIN_KERNELS), else None. Takes the demangled name ("void
    ns::pool_kernel<0, false, true>(PoolSrc, ...)") or the mangled one."""
    if name.startswith("_Z"):
        base, rest = entry_name(name)
        targs = re.match(r"I(.*?E)E", rest)
        args = [int(v) for v in re.findall(r"L[ib](\d+)E", targs.group(1))
                ] if targs else []
    else:
        m = _MAIN_RE.search(name)
        if m is None:
            return None
        base = m.group(1)
        args = [1 if v.strip() == "true" else 0 if v.strip() == "false"
                else int(re.search(r"-?\d+", v).group())
                for v in (m.group(2) or "").split(",") if v.strip()]
    if base not in MAIN_KERNELS:
        return None
    key, n_args, form = MAIN_KERNELS[base]
    if len(args) < n_args:
        raise AssertionError(f"cannot read the form of kernel {name!r}")
    return key, form(args)


def profiled_launches(events, booked: dict) -> dict:
    """The launches that a profile's device records (kineto events) show,
    per module key
    and form as counted gives them (booked: its counts of the same call):
    each record of a main kernel (kernel_form) counts one; BOOKED_ONLY
    are taken from `booked`."""
    from torch.autograd import DeviceType
    got = {k: {f: (v if f in BOOKED_ONLY else 0) for f, v in c.items()}
           for k, c in booked.items()}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            kf = kernel_form(e.name())
            if kf is not None:
                got[kf[0]][kf[1]] += 1
    return got


def nonzero(counts: dict) -> dict:
    return {k: {f: v for f, v in c.items() if v}
            for k, c in counts.items() if any(c.values())}


# profiled runs of a call, at most, until one shows its launches, and
# the tiny kernels (torch.cuda._sleep's spin_kernel) that each further run
# launches first, per run already taken
PROFILE_TRIES = 4
PROFILE_SHIFT = 3


def profile_launches(fn, hold: bool = True):
    """fn() under torch.profiler (CUDA activity only), its main kernels'
    records counted (profiled_launches) beside the bookkeeping of the
    same call (counted). The profiler can drop a record (95 of 96 K1a on
    an eager 1M query; 95 of 96 K5, and of K3 in three runs running, on
    replays) but shows none that did not run: a run that shows the
    bookkeeping's count proves those launches ran. hold: run fn again, at
    most PROFILE_TRIES times in all, until one run shows it, each further
    run after PROFILE_SHIFT more tiny kernels than the last (a loss that
    repeats in runs of the same work then falls elsewhere in the next);
    raise if none shows it or one shows more. Returns (fn(), the last
    run's profiled launches, its bookkeeping, its events, the runs
    taken)."""
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_SHIFT * (tries - 1)):
                torch.cuda._sleep(1)
            out, booked = counted(fn)
            torch.cuda.synchronize()
        # the profiler's own records (prof.events() builds an event tree
        # from them, ~20x slower at 200k records)
        events = prof.profiler.kineto_results.events()
        got = profiled_launches(events, booked)
        if not hold or got == booked:
            return out, got, booked, events, tries
        seen.append(nonzero(got))
        if any(v > booked[k][f] for k, c in got.items()
               for f, v in c.items()):
            break
    raise AssertionError(f"launches on the card's profile {seen}, by the "
                         f"bookkeeping {nonzero(booked)}")


def measured(fn, want=None):
    """(fn(), launches measured on the card: profile_launches held to the
    bookkeeping). Raises unless they also equal `want`, where given (the
    counts of other, unprofiled calls, such as the timed ones)."""
    out, got, _, _, _ = profile_launches(fn)
    if want is not None and got != want:
        raise AssertionError(f"launches on the card's profile "
                             f"{nonzero(got)}, of the timed calls "
                             f"{nonzero(want)}")
    return out, got


def launched(counts: dict, want: dict) -> dict:
    """counts (from counted) as they should be: every count 0 but those
    of `want`, {module key: {form: launches}}."""
    return {k: {f: want.get(k, {}).get(f, 0) for f in v}
            for k, v in counts.items()}


def gwalk_tree(pos, mass, cfg, theta: float = THETA):
    """A Tree sized as bench.py sizes its gwalk run: tile_cap fitted to
    1.1x the built tile count, rounded up to 256 (bench.py:103-111), then
    the global and per-round caps from engine.tune_gwalk
    (bench.py:130-140), tuned at theta. Returns the tree and its sizing
    record (build_ms: the last tree's build, its graph's first call)."""
    from rakau_tpu_torch import Tree, engine
    from rakau_tpu_torch.config import OVF_FIELDS
    n = pos.shape[0]
    tree = Tree(coords=pos, masses=mass, config=cfg)
    tiles = int(tree.tree_data.n_tiles)
    fitted = -(-int(tiles * 1.1) // 256) * 256
    if fitted < tree.config.tile_capacity(n):
        tree = Tree(coords=pos, masses=mass,
                    config=tree.config.with_(tile_cap=fitted))
    tuned, tune_ms = synced_ms(lambda: engine.tune_gwalk(
        tree.tree_data, tree.config, theta, 0.0))
    del tree
    tree, build_ms = synced_ms(lambda: Tree(coords=pos, masses=mass,
                                            config=tuned))
    return tree, {"n_tiles": tiles, "tile_cap": tuned.tile_capacity(n),
                  "tune_ms": tune_ms, "build_ms": build_ms,
                  "caps": {f: getattr(tuned, f) for f in OVF_FIELDS},
                  "round_caps": list(tuned.gwalk_round_caps),
                  "pool_window": tuned.pool_window}


def one_launch(counts: dict, form: str, what: str):
    """Raise unless `counts` (from counted) shows exactly one K2 launch,
    of `form`, and no other launch."""
    want = launched(counts, {"K2": {form: 1}})
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, want one K2 "
                             f"{form} and nothing else")


def gwalk_main(pos, mass, oracle, shared_rms, dev):
    """The gwalk+grid query (phase g) and its layers and profile. Returns
    the tree, the warm queries' launches and the record."""
    from rakau_tpu_torch.config import TreeConfig
    n = pos.shape[0]
    (tree, rec), sizing_ms = synced_ms(lambda: gwalk_tree(
        pos, mass, TreeConfig(farfield="grid", **gwalk_kw(n))))
    _, cold_ms = event_ms(lambda: tree.accs_pots_o(THETA))
    warm, per_query = [], []
    for _ in range(WARM_REPS):
        ((acc, pot), ms), counts = counted(
            lambda: event_ms(lambda: tree.accs_pots_o(THETA)))
        warm.append(ms)
        per_query.append(counts["K2"]["mono"])
        one_launch(counts, "mono", "gwalk warm query")
    if acc.shape != (n, 3) or pot.shape != (n,):
        raise AssertionError(f"bad shapes {acc.shape} {pot.shape}")
    if not (torch.isfinite(acc).all() and torch.isfinite(pot).all()):
        raise AssertionError("non-finite gwalk accelerations or potentials")
    f_rms, p_rms = sampled_rms(acc, pot, *oracle, dev)
    warm_ms = statistics.median(warm)
    rec.update(n=n, theta=THETA, farfield="grid", sizing_ms=sizing_ms,
               cold_query_ms=cold_ms, warm_query_ms=warm_ms,
               warm_query_ms_all=warm,
               warm_spread=(max(warm) - min(warm)) / warm_ms,
               booked_k2_launches_per_warm_query=per_query,
               evals_per_s=n / (warm_ms / 1e3), force_rms=f_rms,
               pot_rms=p_rms, shared_force_rms=shared_rms[0],
               shared_pot_rms=shared_rms[1])
    emit("gwalk", **rec)
    if not (f_rms < FORCE_RMS_MAX and p_rms < POT_RMS_MAX):
        raise AssertionError(f"gwalk accuracy: force rms {f_rms:.3e}, pot "
                             f"rms {p_rms:.3e}")
    emit("gwalk_layers", warm_query_ms=warm_ms, **gwalk_layer_ms(tree))
    prof = device_profile(tree, K2_KERNELS, "k2_device_ms")
    one_launch(prof["launches"], "mono", "gwalk profiled query")
    emit("gwalk_profile", **profile_record(prof, warm_ms))
    rec["graphs"] = graph_ab(tree, "gwalk+grid", {"K2": {"mono": 1}},
                             K2_KERNELS, "k2_device_ms")
    return tree, prof["launches"]["K2"]["mono"], rec


def gwalk_quad(pos, mass, oracle, dev):
    """Phase gwalk_quad: farfield "m2p" monopole fp32, then quadrupole +
    compensated (pool_window 131072, bench.py:81-85), each sized by
    gwalk_tree; each configuration queried again with the other
    accumulation, so that every K2 form runs once in a real query (each
    timed query's launches held to a profiled one's, measured).
    Returns the quadrupole + compensated tree and the launches per form."""
    from rakau_tpu_torch import Tree
    from rakau_tpu_torch.config import TreeConfig
    n = pos.shape[0]
    mono = TreeConfig(farfield="m2p", **gwalk_kw(n))
    rec, launches, rms = {"n": n, "theta": THETA}, {}, {}
    qtree = None
    for form, other, cfg in (
            ("mono", "mono_comp", mono),
            ("quad_comp", "quad", mono.with_(
                multipole_order=2, accum="compensated",
                pool_window=QUAD_POOL_WINDOW))):
        (tree, sizing), sizing_ms = synced_ms(lambda: gwalk_tree(pos, mass,
                                                                 cfg))
        _, cold_ms = event_ms(lambda: tree.accs_pots_o(THETA))
        ((acc, pot), warm_ms), counts = counted(
            lambda: event_ms(lambda: tree.accs_pots_o(THETA)))
        one_launch(counts, form, f"gwalk m2p {form} query")
        _, counts = measured(lambda: tree.accs_pots_o(THETA), want=counts)
        launches[form] = counts["K2"][form]
        rms[form] = sampled_rms(acc, pot, *oracle, dev)
        acc_cfg = tree.config.with_(
            accum="fp32" if cfg.accum == "compensated" else "compensated")
        otree = Tree(coords=pos, masses=mass, config=acc_cfg)
        otree.accs_pots_o(THETA)        # captures its graph
        ((acc2, pot2), other_ms), counts = counted(
            lambda: event_ms(lambda: otree.accs_pots_o(THETA)))
        one_launch(counts, other, f"gwalk m2p {other} query")
        _, counts = measured(lambda: otree.accs_pots_o(THETA), want=counts)
        launches[other] = counts["K2"][other]
        rms[other] = sampled_rms(acc2, pot2, *oracle, dev)
        for t in (acc, pot, acc2, pot2):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError("non-finite gwalk m2p result")
        rec[form] = dict(sizing, sizing_ms=sizing_ms, cold_query_ms=cold_ms,
                         warm_query_ms=warm_ms, force_rms=rms[form][0],
                         pot_rms=rms[form][1])
        rec[other] = dict(warm_query_ms=other_ms, force_rms=rms[other][0],
                          pot_rms=rms[other][1])
        del otree
        if form == "quad_comp":
            qtree = tree
        del tree
    # the shared engine on the same particles and far field, beside it
    shared_cfg = mono.with_(traversal_mode="shared", **SHARED_M2P_CAPS)
    for form, cfg in (("mono", shared_cfg),
                      ("quad_comp", shared_cfg.with_(
                          multipole_order=2, accum="compensated"))):
        stree = Tree(coords=pos, masses=mass, config=cfg)
        (acc, pot), ms = synced_ms(lambda: stree.accs_pots_o(THETA))
        rms["shared_" + form] = sampled_rms(acc, pot, *oracle, dev)
        rec["shared_" + form] = dict(query_ms=ms,
                                     force_rms=rms["shared_" + form][0],
                                     pot_rms=rms["shared_" + form][1])
        del stree
    ratio = rms["quad_comp"][0] / rms["mono"][0]
    emit("gwalk_quad", **rec, force_rms_ratio=ratio, launches=launches)
    if not ratio < QUAD_RMS_RATIO:
        raise AssertionError(f"gwalk quadrupole force rms "
                             f"{rms['quad_comp'][0]:.3e} is not below "
                             f"{QUAD_RMS_RATIO} x the monopole's "
                             f"{rms['mono'][0]:.3e}")
    for form in ("mono", "quad_comp"):
        g, s = rms[form][0], rms["shared_" + form][0]
        if not abs(g - s) < SHARED_RMS_RTOL * s:
            raise AssertionError(f"gwalk {form} force rms {g:.6e} is not "
                                 f"within {SHARED_RMS_RTOL} of the shared "
                                 f"engine's {s:.6e}")
    return qtree, launches


def pool_kernel_phase(tree, forms, label: str) -> dict:
    """Phase kernel for K2 on the pool of `tree`'s gwalk query."""
    from rakau_tpu_torch import engine
    td, cfg = tree.tree_data, tree.config
    n = int(td.pos.shape[0])
    inputs = engine.pool_inputs(td, cfg, THETA, 0.0)
    out = pool_kernels(inputs, n, cfg.pool_window, cfg.pool_block, forms)
    emit("kernel", config=label, G=int(inputs[0].shape[0]),
         T=int(inputs[0].shape[1]), P=int(inputs[2].shape[0]),
         subset_tiles=SUBSET_TILES,
         segments=pool_segments(inputs, n, cfg.pool_window, cfg.pool_block),
         forms=out)
    return out


def finite(what: str, *tensors):
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {what}")


def k1_launches(counts: dict, chunks: int, forms, what: str):
    """Raise unless `counts` (from counted) shows `chunks` launches of each
    K1 form in `forms` and no other launch of K1 or K2."""
    want = launched(counts, {"K1": {f: chunks for f in forms}})
    if counts != want or chunks <= 0:
        raise AssertionError(f"{what}: launches {counts}, want {chunks} of "
                             f"each of {forms} and nothing else")


def grid2_shared(pos, mass, oracle, shared_rms, dev):
    """Phase grid2: the shared traversal with the conv-M2L far field.
    Returns the order-4 monopole tree, the quadrupole + compensated tree,
    the launches per K1c form in one warm query of each, and the record."""
    from rakau_tpu_torch import Tree, engine, grid2
    from rakau_tpu_torch.config import OVF_FIELDS, TreeConfig
    n = pos.shape[0]
    cfg0 = TreeConfig(**{**TREE_KW, **GRID2_KW})
    (tree, build_ms) = synced_ms(lambda: Tree(coords=pos, masses=mass,
                                              config=cfg0))
    # the first query grows what overflows; tune_caps then fits the caps
    _, cold_ms = event_ms(lambda: tree.accs_pots_o(THETA))
    grown = {f: getattr(tree.config, f) for f in OVF_FIELDS}
    tree.tune_caps()
    _, settle_ms = event_ms(lambda: tree.accs_pots_o(THETA))
    td, cfg = tree.tree_data, tree.config
    chunks = engine.live_chunks(td, cfg)
    warm, per_query = [], []
    for _ in range(WARM_REPS):
        ((acc, pot), ms), counts = counted(
            lambda: event_ms(lambda: tree.accs_pots_o(THETA)))
        warm.append(ms)
        per_query.append(counts["K1"]["mono_cell"])
        k1_launches(counts, query_chunks(td, cfg), ("mono_cell",),
                    "grid2 warm query")
    if acc.shape != (n, 3) or pot.shape != (n,):
        raise AssertionError(f"bad shapes {acc.shape} {pot.shape}")
    finite("grid2 accelerations or potentials", acc, pot)
    f_rms, p_rms = sampled_rms(acc, pot, *oracle, dev)
    warm_ms = statistics.median(warm)
    _, got = measured(lambda: tree.accs_pots_o(THETA), want=counts)
    launches = {"mono_cell": got["K1"]["mono_cell"]}
    rec = dict(n=n, theta=THETA, **GRID2_KW,
               grid_level=grid2.effective_grid_level(cfg, n),
               build_ms=build_ms, cold_query_ms=cold_ms, caps_grown=grown,
               caps={f: getattr(cfg, f) for f in OVF_FIELDS},
               first_query_after_tune_ms=settle_ms, warm_query_ms=warm_ms,
               warm_query_ms_all=warm,
               warm_spread=(max(warm) - min(warm)) / warm_ms,
               n_tiles=int(td.n_tiles), chunks=chunks,
               booked_launches_per_warm_query=per_query,
               measured_launches=nonzero(got),
               evals_per_s=n / (warm_ms / 1e3), force_rms=f_rms,
               pot_rms=p_rms, shared_grid_force_rms=shared_rms[0],
               shared_grid_pot_rms=shared_rms[1])

    # the accuracy shape: order 6, quadrupole node rows, compensated sums;
    # then the same with fp32 sums, so that every K1c form runs in a query
    qtree = None
    for key, kw, forms in (
            ("quad_comp", GRID2_QUAD_KW, ("quad_comp_cell",
                                          "mono_comp_cell")),
            ("quad_fp32", dict(GRID2_QUAD_KW, accum="fp32"),
             ("quad_cell", "mono_cell"))):
        t2 = Tree(coords=pos, masses=mass, config=cfg.with_(**kw))
        _, q_cold = event_ms(lambda: t2.accs_pots_o(THETA))
        ((qacc, qpot), q_ms), counts = counted(
            lambda: event_ms(lambda: t2.accs_pots_o(THETA)))
        k1_launches(counts, query_chunks(t2.tree_data, t2.config),
                    forms, f"grid2 {key} query")
        _, counts = measured(lambda: t2.accs_pots_o(THETA), want=counts)
        finite(f"grid2 {key} result", qacc, qpot)
        qf, qp = sampled_rms(qacc, qpot, *oracle, dev)
        rec[key] = dict(kw, cold_query_ms=q_cold, warm_query_ms=q_ms,
                        force_rms=qf, pot_rms=qp,
                        force_rms_ratio=qf / f_rms,
                        caps={f: getattr(t2.config, f) for f in OVF_FIELDS})
        for f in forms:
            launches.setdefault(f, counts["K1"][f])
        if key == "quad_comp":
            qtree = t2
    emit("grid2", **rec)
    if not (f_rms < FORCE_RMS_MAX and p_rms < POT_RMS_MAX):
        raise AssertionError(f"grid2 accuracy: force rms {f_rms:.3e}, pot "
                             f"rms {p_rms:.3e}")
    for key in ("quad_comp", "quad_fp32"):
        if not rec[key]["force_rms"] < f_rms:
            raise AssertionError(
                f"grid2 {key} force rms {rec[key]['force_rms']:.3e} is not "
                f"below the order-4 monopole's {f_rms:.3e}")
    return tree, qtree, launches, rec


def grid2_layer_ms(tree, warm_ms: float) -> dict:
    """Phase grid2_layers. A warm shared+grid2 query split between device
    syncs: the walk, the kernel call (active-block lists, K1c, the G
    scale), the L2P of the kept leaf locals, the rest. Then what the tree
    keeps between queries, built anew: the pyramid, and per level of the
    M2L pass the kernels W and the convolutions (the port's form, and the
    same through cuDNN beside it), and the L2L chain with the rest of
    dense_far_field."""
    from rakau_tpu_torch import engine, grid2, traversal2
    from rakau_tpu_torch.kernels import dispatch
    tree.accs_pots_o(THETA)     # the tree's state back into the engine's
    #                             two-tree cache, after the other trees
    t, total = synced_layers(tree, ((traversal2, "build_shared_sources"),
                                    (engine, "_chunk_sources"),
                                    (dispatch, "eval_shared"),
                                    (grid2, "l2p_particles")))
    out = {"warm_query_ms": warm_ms, "walk_ms": t["build_shared_sources"],
           "chunk_rest_ms": t["_chunk_sources"] - t["build_shared_sources"],
           "kernel_call_ms": t["eval_shared"], "l2p_ms": t["l2p_particles"],
           "synced_query_ms": total}
    out["rest_ms"] = total - t["_chunk_sources"] - t["eval_shared"] \
        - t["l2p_particles"]

    td, cfg = tree.tree_data, tree.config
    L0 = grid2.effective_grid_level(cfg, td.pos.shape[0])
    p, q = grid2.grid_orders(cfg)
    pyr, out["pyramid_ms"] = synced_ms(
        lambda: grid2.build_pyramid(td, cfg, L0, q))
    lt: dict = {}
    with ExitStack() as stack:
        for name in ("m2l_kernels", "_parity_conv"):
            stack.enter_context(synced(grid2, name, lt))
        _, dense_ms = synced_ms(lambda: grid2.dense_far_field(
            pyr, cfg, L0, td.box_size, 0.0, p, q, cfg.grid_sep))
    W = grid2.m2l_kernels(3, p, q, cfg.grid_sep, 1.0, 0.0, torch.float32,
                          td.pos.device)
    levels = {}
    for lvl in range(2, L0 + 1):
        M = pyr.mom[lvl]
        own = cuda_ms(lambda: grid2._parity_conv(M, W, 3, 1 << lvl), 3)
        cudnn = cuda_ms(lambda: grid2._parity_conv(M, W, 3, 1 << lvl,
                                                   cudnn=True), 3)
        a = grid2._parity_conv(M, W, 3, 1 << lvl)
        b = grid2._parity_conv(M, W, 3, 1 << lvl, cudnn=True)
        ref = grid2._parity_conv(M.double(), W.double(), 3, 1 << lvl)
        scale = float(ref.abs().max())
        levels[lvl] = {"conv_ms": own, "conv_cudnn_ms": cudnn,
                       "rel_err": float((a - ref).abs().max()) / scale,
                       "rel_err_cudnn": float((b - ref).abs().max()) / scale}
    out.update(grid_level=L0, local_order=p, grid_multipole_order=q,
               grid_sep=cfg.grid_sep, dense_far_field_ms=dense_ms,
               m2l_kernels_ms=lt["m2l_kernels"],
               m2l_conv_ms=lt["_parity_conv"],
               l2l_and_rest_ms=dense_ms - lt["m2l_kernels"]
               - lt["_parity_conv"], conv_levels=levels,
               kernel_bytes=W.numel() * W.element_size())
    return out


def grid2_tf32(tree, dev) -> dict:
    """Phase grid2_tf32: the order-6 far field in float32 against the same
    in float64 on the card, with both global TF32 switches turned on for
    the duration. A particle that the float64 cell map puts into another
    leaf cell than the float32 one (a position on a cell face) is left
    out: its two fields are expansions about different centres."""
    from rakau_tpu_torch import grid2
    td = tree.tree_data
    cfg = tree.config.with_(local_order=6)
    L0 = grid2.effective_grid_level(cfg, td.pos.shape[0])
    td64 = td._replace(pos=td.pos.double(), mass=td.mass.double(),
                       box_size=td.box_size.double())
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        (acc, pot), ms32 = synced_ms(lambda: grid2.far_field(td, cfg, 0.0,
                                                             1.0))
        (acc64, pot64), ms64 = synced_ms(lambda: grid2.far_field(
            td64, cfg, 0.0, 1.0))
        switches_on = (torch.backends.cuda.matmul.allow_tf32
                       and torch.backends.cudnn.allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    same = (grid2.particle_cells(td.pos, td.box_size, cfg.max_depth, L0)
            == grid2.particle_cells(td64.pos, td64.box_size, cfg.max_depth,
                                    L0)).all(1)
    a_rel = float((acc.double() - acc64)[same].abs().max()
                  / acc64.abs().max())
    p_rel = float((pot.double() - pot64)[same].abs().max()
                  / pot64.abs().max())
    rec = dict(local_order=6, grid_sep=cfg.grid_sep, grid_level=L0,
               tf32_switches_on=bool(switches_on), acc_rel=a_rel,
               pot_rel=p_rel, left_out=int((~same).sum()),
               far_field_fp32_ms=ms32, far_field_fp64_ms=ms64)
    emit("grid2_tf32", **rec)
    if not switches_on:
        raise AssertionError("grid2 left the global TF32 switches changed")
    if not (a_rel < TF32_REL_MAX and p_rel < TF32_REL_MAX):
        raise AssertionError(f"grid2 far field float32 vs float64: acc "
                             f"{a_rel:.3e}, pot {p_rel:.3e}")
    return rec


def cell_kernels(tree, qtree, n: int) -> dict:
    """Phase kernel for K1c: mono_cell on the first two chunks of the
    shared+grid2 query; on the first chunk of the quadrupole + compensated
    one, quad_comp_cell and quad_cell on the node rows [0, U) and
    mono_comp_cell on the particle rows [U, S); against plain PyTorch in
    every mode, both timed. Returns per form (worst error, ms, plain_ms,
    bound_ms, bound_by of mode both; means over the chunks)."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import shared
    runs = []
    td, cfg = tree.tree_data, tree.config
    for ch in range(min(2, engine.live_chunks(td, cfg))):
        inp = engine.kernel_inputs(td, cfg, THETA, 0.0, ch)
        runs.append(("mono_cell", f"grid2 chunk {ch}", inp[:6], {},
                     (inp[7], inp[8], cfg.grid_sep)))
    td, cfg = qtree.tree_data, qtree.config
    inp = engine.kernel_inputs(td, cfg, THETA, 0.0, 0)
    quad, scell, tcell = inp[6:9]
    U = quad.shape[0]
    mask = inp[5]
    nodes = inp[:2] + tuple(t[:U] for t in inp[2:5]) \
        + (mask[:, :U].contiguous(),)
    parts = inp[:2] + tuple(t[U:] for t in inp[2:5]) \
        + (mask[:, U:].contiguous(),)
    sep = cfg.grid_sep
    runs += [("quad_comp_cell", "grid2 quad chunk 0 nodes", nodes,
              dict(compensated=True, src_quad=quad), (scell[:U], tcell, sep)),
             ("quad_cell", "grid2 quad chunk 0 nodes", nodes,
              dict(src_quad=quad), (scell[:U], tcell, sep)),
             ("mono_comp_cell", "grid2 quad chunk 0 particles", parts,
              dict(compensated=True), (scell[U:], tcell, sep))]
    per_form: dict = {}
    for form, label, args, kw, cells in runs:
        ckw = dict(src_cell=cells[0], tgt_cell=cells[1], grid_sep=cells[2])
        modes = {}
        for mode in MODES:
            got = shared.eval_shared_fused(
                *args, scal(0.0, 1.0, args[0]), mode=mode, **kw, **ckw)
            want = shared.eval_shared_plain(
                *args, scal(0.0, 1.0, args[0]), mode=mode, **kw, **ckw)
            err = compare(got, want)
            km = cuda_ms(lambda: shared.eval_shared_fused(
                *args, scal(0.0, 1.0, args[0]), mode=mode, **kw, **ckw), 10)
            pm = cuda_ms(lambda: shared.eval_shared_plain(
                *args, scal(0.0, 1.0, args[0]), mode=mode, **kw, **ckw), 1)
            modes[mode] = {"ms": km, "plain_ms": pm, "max_abs_err": err}
        # the same rows without the cell test, beside it
        free_ms = cuda_ms(lambda: shared.eval_shared_fused(
            *args, scal(0.0, 1.0, args[0]), **kw), 10)
        quad_form = "src_quad" in kw
        b_ms, b_by = bound(args + ((quad,) if quad_form else ()), n,
                           quad=quad_form, comp=kw.get("compensated", False),
                           cells=cells)
        C, T, _ = args[0].shape
        live = float((args[5].sum(1).double()
                      * (args[1] < n).sum(1).double()).sum())
        emit("kernel", config=label, form=form, C=C, T=T,
             S=int(args[2].shape[0]),
             **k1_shape(args, kw.get("compensated", False), quad_form,
                        cells),
             mask_true_pairs=live,
             surviving_pairs=surviving_pairs(args, cells, n), modes=modes,
             ms_without_cell_test=free_ms, bound_ms=b_ms, bound_by=b_by,
             pct_of_bound=100 * b_ms / modes["both"]["ms"])
        per_form.setdefault(form, []).append(dict(
            max_abs_err=max(v["max_abs_err"] for v in modes.values()),
            ms=modes["both"]["ms"], plain_ms=modes["both"]["plain_ms"],
            bound_ms=b_ms, bound_by=b_by))
    return {form: dict(
        max_abs_err=max(r["max_abs_err"] for r in rs),
        ms=float(np.mean([r["ms"] for r in rs])),
        plain_ms=float(np.mean([r["plain_ms"] for r in rs])),
        bound_ms=float(np.mean([r["bound_ms"] for r in rs])),
        bound_by=max((r["bound_ms"], r["bound_by"]) for r in rs)[1])
        for form, rs in per_form.items()}


def gwalk_grid2(pos, mass, oracle, grid2_rms, dev) -> dict:
    """Phase gwalk_grid2: gwalk with the conv-M2L far field, monopole then
    quadrupole (pool_window 131072), each sized by gwalk_tree: one K2
    launch per warm query and no K1 launch. gwalk's leaf grid tracks the
    tile size (level 3 at 1M) where the shared traversal's tracks the
    occupancy (level 5), so its error is held to the shared engine's at
    gwalk's level, queried here on the same particles; the shared run at
    its own level is reported beside it."""
    from rakau_tpu_torch import Tree, grid2
    from rakau_tpu_torch.config import TreeConfig
    n = pos.shape[0]
    mono = TreeConfig(**{**gwalk_kw(n), **GRID2_KW})
    L0 = grid2.effective_grid_level(mono, n)
    stree = Tree(coords=pos, masses=mass, config=mono.with_(
        traversal_mode="shared", grid_level=L0, **SHARED_M2P_CAPS))
    (sacc, spot), s_ms = synced_ms(lambda: stree.accs_pots_o(THETA))
    same_level = sampled_rms(sacc, spot, *oracle, dev)
    del stree, sacc, spot
    rec = {"n": n, "theta": THETA, **GRID2_KW, "grid_level": L0,
           "shared_grid2_same_level_force_rms": same_level[0],
           "shared_grid2_same_level_pot_rms": same_level[1],
           "shared_grid2_same_level_query_ms": s_ms,
           "shared_grid2_force_rms": grid2_rms[0],
           "shared_grid2_pot_rms": grid2_rms[1]}
    rms = {}
    for form, cfg in (("mono", mono),
                      ("quad", mono.with_(multipole_order=2,
                                          pool_window=QUAD_POOL_WINDOW))):
        (tree, sizing), sizing_ms = synced_ms(lambda: gwalk_tree(pos, mass,
                                                                 cfg))
        _, cold_ms = event_ms(lambda: tree.accs_pots_o(THETA))
        warm = []
        for _ in range(WARM_REPS if form == "mono" else 1):
            ((acc, pot), ms), counts = counted(
                lambda: event_ms(lambda: tree.accs_pots_o(THETA)))
            one_launch(counts, form, f"gwalk grid2 {form} warm query")
            warm.append(ms)
        finite(f"gwalk grid2 {form} result", acc, pot)
        rms[form] = sampled_rms(acc, pot, *oracle, dev)
        layers = gwalk_layer_ms(tree) if form == "mono" else None
        rec[form] = dict(sizing, sizing_ms=sizing_ms, cold_query_ms=cold_ms,
                         warm_query_ms=statistics.median(warm),
                         warm_query_ms_all=warm, force_rms=rms[form][0],
                         pot_rms=rms[form][1], layers=layers)
        del tree
    ratio = rms["quad"][0] / rms["mono"][0]
    emit("gwalk_grid2", **rec, force_rms_ratio=ratio)
    f_rms, p_rms = rms["mono"]
    if not (f_rms < FORCE_RMS_MAX and p_rms < POT_RMS_MAX):
        raise AssertionError(f"gwalk grid2 accuracy: force rms {f_rms:.3e}, "
                             f"pot rms {p_rms:.3e}")
    if not abs(f_rms - same_level[0]) < SHARED_RMS_RTOL * same_level[0]:
        raise AssertionError(f"gwalk grid2 force rms {f_rms:.3e} is not "
                             f"within {SHARED_RMS_RTOL} of the shared "
                             f"engine's at the same grid level, "
                             f"{same_level[0]:.3e}")
    if not ratio < QUAD_RMS_RATIO:
        raise AssertionError(f"gwalk grid2 quadrupole force rms "
                             f"{rms['quad'][0]:.3e} is not below "
                             f"{QUAD_RMS_RATIO} x the monopole's "
                             f"{f_rms:.3e}")
    return rec


def warm_counted(tree, reps: int, theta: float = THETA):
    """`reps` warm queries through the entry point, each timed and counted
    (counted), then one more under the profiler (measured), whose launches
    the last timed query's count must equal. Returns the last timed (acc,
    pot), the device ms of each and the launches of each: the counts of
    the timed queries, the last one's those measured."""
    ms_all, booked = [], []
    for _ in range(reps):
        ((acc, pot), ms), counts = counted(
            lambda: event_ms(lambda: tree.accs_pots_o(theta)))
        ms_all.append(ms)
        booked.append(counts)
    _, got = measured(lambda: tree.accs_pots_o(theta), want=booked[-1])
    return (acc, pot), ms_all, booked[:-1] + [got]


def variant_queries(tree, oracle, fused_rms, form: str, dev) -> tuple:
    """Phase variants: the whole query of `tree` under
    dispatch.shared_variant: "mma" at each precision and, where `form` is
    "mma" (no cells), "blocks". Each must launch its own kernel once a live
    chunk and no other; x3, highest and K5 must give the fused kernel's
    force RMS within VARIANT_RMS_RTOL and meet the accuracy bounds; one
    bf16 pass is held to BF16_FORCE_RMS_MAX. Each variant's kernel call
    (dispatch.eval_shared between device syncs, one warm query) is
    recorded beside the fused kernel's.
    Returns the record and the launches per variant."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import dispatch
    chunks = query_chunks(tree.tree_data, tree.config)
    runs = [("mma", prec, form) for prec in PRECS]
    if form == "mma":
        runs.append(("blocks", "x3", "blocks"))
    layers = ((dispatch, "eval_shared"),)
    rec, launches = {"chunks": chunks, "fused_force_rms": fused_rms[0],
                     "fused_pot_rms": fused_rms[1],
                     "fused_kernel_call_ms": synced_layers(
                         tree, layers)[0]["eval_shared"]}, {}
    for name, prec, key in runs:
        label = f"{name}/{prec}" if name == "mma" else name
        with dispatch.shared_variant(name, prec):
            (acc, pot), ms, counts = warm_counted(tree, 2)
            call_ms = synced_layers(tree, layers)[0]["eval_shared"]
        k1_launches(counts[-1], chunks, (key,), f"variant {label} query")
        finite(f"variant {label} result", acc, pot)
        f_rms, p_rms = sampled_rms(acc, pot, *oracle, dev)
        rec[label] = dict(warm_query_ms=ms, force_rms=f_rms, pot_rms=p_rms,
                          launches=counts[-1]["K1"][key],
                          kernel_call_ms=call_ms)
        launches[label] = counts[-1]["K1"][key]
        f_max = BF16_FORCE_RMS_MAX if prec == "bf16" else FORCE_RMS_MAX
        if not (f_rms < f_max and p_rms < POT_RMS_MAX):
            raise AssertionError(f"variant {label}: force rms {f_rms:.3e}, "
                                 f"pot rms {p_rms:.3e}")
        if prec != "bf16" and not abs(f_rms - fused_rms[0]) \
                < VARIANT_RMS_RTOL * fused_rms[0]:
            raise AssertionError(
                f"variant {label}: force rms {f_rms:.6e} is not within "
                f"{VARIANT_RMS_RTOL} of the fused kernel's "
                f"{fused_rms[0]:.6e}")
    return rec, launches


def variant_launches(tree, label: str) -> dict:
    """Phase variant_launches: one eager query (graph=False) of `tree`,
    whose chunks variant_kernels times, under dispatch.shared_variant for
    "mma" at each precision and for "blocks", counted: each must launch
    its own kernel once a chunk evaluation and no other kernel. Returns
    the launches per variant, which the kernels line pairs with
    variant_kernels' times on the same tree."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import dispatch
    td, cfg = tree.tree_data, tree.config
    chunks = query_chunks(td, cfg)
    runs = [("mma", prec, "mma") for prec in PRECS] + [
        ("blocks", "x3", "blocks")]
    launches, seconds = {}, {}
    for name, prec, key in runs:
        label_v = f"{name}/{prec}" if name == "mma" else name
        with dispatch.shared_variant(name, prec):
            (_, s), counts = counted(lambda: synced_ms(
                lambda: engine.acc_pot_u_host(td, cfg, THETA, 0.0, 1.0,
                                              graph=False)))
        k1_launches(counts, chunks, (key,), f"variant {label_v} eager query")
        launches[label_v] = counts["K1"][key]
        seconds[label_v] = s / 1e3
    emit("variant_launches", config=label, n=int(td.pos.shape[0]),
         chunks=chunks, launches=launches, eager_query_s=seconds)
    return launches


def variant_kernels(tree, n: int, label: str) -> dict:
    """Phase kernel for K6 (and, on rows without cells, K5) on chunks 0 and
    1 of `tree`'s query: every precision and mode against the plain
    version, CUDA-event ms per call, the bound, % of it, the plain
    version's ms and K6's launch shape (k6_shape: granules, spans, work
    items, CUDA blocks, warps a SM, registers), beside the fused kernel's
    (K1a or K1c) ms, % of its bound and shape on the same rows; K5 also
    twice for bit-equal results, its card plan against fused_plan's and
    its launch shape (k5_shape). Returns per form (worst error, ms,
    plain_ms, bound_ms, bound_by; means over the chunks)."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import shared
    td, cfg = tree.tree_data, tree.config
    per_form: dict = {}
    for ch in range(min(2, engine.live_chunks(td, cfg))):
        inp = engine.kernel_inputs(td, cfg, THETA, 0.0, ch)
        args = inp[:6]
        cells = (inp[7], inp[8], cfg.grid_sep) if inp[7] is not None else None
        ckw = dict(src_cell=cells[0], tgt_cell=cells[1],
                   grid_sep=cells[2]) if cells else {}
        C, T, _ = args[0].shape
        S = int(args[2].shape[0])
        fused_ms = cuda_ms(lambda: shared.eval_shared_fused(
            *args, scal(0.0, 1.0, args[0]), **ckw), 10)
        f_bound, _ = bound(args, n, cells=cells)
        cell = 3 if cells else 0     # the chunks are 3-D
        rec = dict(config=label, chunk=ch, C=C, T=T, S=S, fused_ms=fused_ms,
                   fused=dict(k1_shape(args, cells=cells), bound_ms=f_bound,
                              pct_of_bound=100 * f_bound / fused_ms,
                              registers=REGISTERS.get("shared_fused", {}).get(
                                  f"shared_fused_kernel<0,0,0,{cell}>")),
                   forms={})
        for prec in PRECS:
            modes = {}
            for mode in MODES:
                kw = dict(mode=mode, prec=prec, **ckw)
                got = shared.eval_shared_mma(
                    *args, scal(0.0, 1.0, args[0]), **kw)
                want = shared.eval_shared_mma_plain(
                    *args, scal(0.0, 1.0, args[0]), **kw)
                err = compare(got, want, **mma_tol(prec))
                km = cuda_ms(lambda: shared.eval_shared_mma(
                    *args, scal(0.0, 1.0, args[0]), **kw), 10)
                pm = cuda_ms(lambda: shared.eval_shared_mma_plain(
                    *args, scal(0.0, 1.0, args[0]),
                    **kw), 1) if mode == "both" else None
                modes[mode] = {"ms": km, "plain_ms": pm, "max_abs_err": err}
            b_ms, b_by = bound(args, n, cells=cells, per_pair=FLOPS_MMA + (
                TENSOR_FLOPS if prec == "highest" else 0),
                tensor_flops=TENSOR_FLOPS * MMA_PASSES[prec])
            form = ("mma_cell/" if cells else "mma/") + prec
            rec["forms"][form] = dict(
                modes=modes, bound_ms=b_ms, bound_by=b_by,
                pct_of_bound=100 * b_ms / modes["both"]["ms"],
                **k6_shape(args, prec, cells))
            per_form.setdefault(form, []).append(dict(
                max_abs_err=max(v["max_abs_err"] for v in modes.values()),
                ms=modes["both"]["ms"], plain_ms=modes["both"]["plain_ms"],
                bound_ms=b_ms, bound_by=b_by))
        if not cells:
            plan = shared.fused_plan(args[5], shared.BLOCKS_SPAN,
                                     shared.BLOCK)
            if not same_plan(shared.blocks_device_plan(args[5]), plan):
                raise AssertionError("K5: the kernels' plan differs from "
                                     "fused_plan's")
            got = shared.eval_shared_blocks(*args, scal(0.0, 1.0, args[0]))
            again = shared.eval_shared_blocks(*args, scal(0.0, 1.0, args[0]))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("K5: two launches differ")
            want = shared.eval_shared_blocks_plain(
                *args, scal(0.0, 1.0, args[0]))
            err = compare(got, want)
            km = cuda_ms(lambda: shared.eval_shared_blocks(
                *args, scal(0.0, 1.0, args[0])),
                         10)
            pm = cuda_ms(lambda: shared.eval_shared_blocks_plain(
                *args, scal(0.0, 1.0, args[0])), 1)
            b_ms, b_by = bound(args, n)
            rec["forms"]["blocks"] = dict(
                ms=km, plain_ms=pm, max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by, pct_of_bound=100 * b_ms / km,
                source_blocks=-(-S // shared.BLOCK), **k5_shape(args))
            per_form.setdefault("blocks", []).append(dict(
                max_abs_err=err, ms=km, plain_ms=pm, bound_ms=b_ms,
                bound_by=b_by))
        emit("kernel", **rec)
    return {form: dict(
        max_abs_err=max(r["max_abs_err"] for r in rs),
        ms=float(np.mean([r["ms"] for r in rs])),
        plain_ms=float(np.mean([r["plain_ms"] for r in rs])),
        bound_ms=float(np.mean([r["bound_ms"] for r in rs])),
        bound_by=max((r["bound_ms"], r["bound_by"]) for r in rs)[1])
        for form, rs in per_form.items()}


def density(tree, label: str) -> dict:
    """Phase metrics, first half: metrics.collect_shared_density on
    `tree`'s query, and the check that its processed pairs are what the
    plan that K1's kernels build on the card (shared.fused_device_plan:
    active granules) gives for the engine's masks on the same chunks,
    where that plan must equal shared.fused_plan's lists. K6 runs on the
    same plan: the one its kernels build must equal it too, and the pairs
    metrics.processed_pairs replays under the "mma" variant are its. K5's
    kernels build its plan at blocks of BLOCK: equal to fused_plan's at
    that unit, and the pairs replayed under "blocks" are its; its density
    (the useful pairs over its processed pairs) is reported beside."""
    from rakau_tpu_torch import engine, metrics
    from rakau_tpu_torch.kernels import shared
    td, cfg = tree.tree_data, tree.config
    stats, ms = synced_ms(lambda: metrics.collect_shared_density(
        td, cfg, THETA, max_chunks=8))
    n_live = engine.live_chunks(td, cfg)
    sample = metrics.sample_chunks(n_live, 8)
    granules = blocks = 0
    for ch in sample:
        mask = engine.kernel_inputs(td, cfg, THETA, 0.0, ch)[5]
        plan = shared.fused_device_plan(mask)
        if not (same_plan(plan, shared.fused_plan(mask)) and same_plan(
                shared.fused_device_plan(mask, "shared_mma"), plan)):
            raise AssertionError(f"{label} chunk {ch}: the kernels' plan "
                                 "differs from fused_plan's")
        if int(metrics.processed_pairs(cfg, mask, "mma")) \
                != int(plan.cnt.sum()) * shared.GRANULE * cfg.ncrit:
            raise AssertionError(f"{label} chunk {ch}: K6's processed pairs "
                                 "are not its plan's")
        k5 = shared.blocks_device_plan(mask)
        if not same_plan(k5, shared.fused_plan(mask, shared.BLOCKS_SPAN,
                                               shared.BLOCK)):
            raise AssertionError(f"{label} chunk {ch}: K5's kernels' plan "
                                 "differs from fused_plan's")
        if int(metrics.processed_pairs(cfg, mask, "blocks")) \
                != int(k5.cnt.sum()) * shared.BLOCK * cfg.ncrit:
            raise AssertionError(f"{label} chunk {ch}: K5's processed pairs "
                                 "are not its plan's")
        granules += int(plan.cnt.sum())
        blocks += int(k5.cnt.sum())
    replay = float(granules * shared.GRANULE * cfg.ncrit) \
        * (n_live / len(sample))
    k5_pairs = float(blocks * shared.BLOCK * cfg.ncrit) \
        * (n_live / len(sample))
    emit("metrics", config=label, collect_ms=ms, chunks=n_live,
         sampled=sample, kernel_plan_pairs=replay,
         blocks_processed_pairs=k5_pairs,
         blocks_density=stats.useful_pairs / k5_pairs, **stats.as_dict())
    if stats.processed_pairs != replay:
        raise AssertionError(f"{label}: processed pairs "
                             f"{stats.processed_pairs} != the kernel plan's "
                             f"{replay}")
    return stats.as_dict()


def kernel_roofs(grid_cfg, cell_cfg) -> dict:
    """Phase metrics, second half: metrics.measure_kernel_roof, the dense
    ceiling in pairs/s at ROOF_SOURCES sources (all-on mask, every pair
    alive), of K1a, K5 and K6 (x3) at the shared+grid configuration and
    K1c and K6 with cells (x3) at the lmac+grid2 one."""
    from rakau_tpu_torch import metrics
    from rakau_tpu_torch.kernels import shared
    out = {}
    for key, cfg, variant, form in (
            ("K1a", grid_cfg, "fused", "mono"),
            ("K1c", cell_cfg, "fused", "mono_cell"),
            ("K6 x3", grid_cfg, "mma", "mma"),
            ("K6 x3 cell", cell_cfg, "mma", "mma_cell"),
            ("K5", grid_cfg, "blocks", "blocks")):
        shared.reset_launches()
        out[key] = metrics.measure_kernel_roof(
            cfg, n_src=ROOF_SOURCES, reps=ROOF_REPS, variant=variant)
        if shared.launches[form] != ROOF_REPS + 1:
            raise AssertionError(f"roof {key}: launches {shared.launches}")
    emit("metrics", roofs_pairs_per_s=out, sources=ROOF_SOURCES,
         reps=ROOF_REPS, C=grid_cfg.tile_chunk, T=grid_cfg.ncrit)
    return out


def lmac_cpu_cuda(seed: int, dev) -> dict:
    """Phase lmac_cpu_cuda: on a 65,536-particle tree, the first slice's
    candidate table and chunk 0's sources from traversal3 on the card
    against the same calls on the CPU, on the same tree: every field
    exactly equal. The acceptance test compares d^2 with R^2 in float32; a
    product and sum contracted on one device alone would flip a node on
    the boundary."""
    from rakau_tpu_torch import Tree, engine, particles, traversal3
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(GATE_N, generator=gen)
    tree = Tree(coords=pos, masses=mass, config=TreeConfig(**LMAC_KW))
    cfg = tree.config
    out = {}
    for where in ("cuda", "cpu"):
        td = type(tree.tree_data)(*(t.to(where) for t in tree.tree_data))
        tiles = engine._gather_tiles(td, cfg)
        tables = traversal3.make_tables(td, cfg)
        _, start, K = engine._slices(engine.live_chunks(td, cfg),
                                     cfg.tile_chunk)[0]
        cand = engine._slice_cand(
            td, cfg, THETA, tuple(t[start:start + K] for t in tiles), tables)
        (tpos, tidx, blo, bhi, tcell), tcells = engine._chunk_tiles(tiles, 0)
        src = traversal3.build_shared_sources(
            td, cfg, THETA, blo, bhi, tables=tables,
            tile_valid=tidx[:, 0] < GATE_N, tcell_lo=tcells[1],
            tcell_hi=tcells[2], cand=cand)
        out[where] = {**{"cand." + f: getattr(cand, f).cpu()
                         for f in cand._fields},
                      **{f: getattr(src, f).cpu() for f in src._fields
                         if getattr(src, f) is not None}}
    differ = [f for f in out["cuda"]
              if not torch.equal(out["cuda"][f], out["cpu"][f])]
    rec = dict(n=GATE_N, fields=sorted(out["cuda"]), differ=differ,
               group_rows=int(out["cuda"]["cand.count"]),
               sources=int(out["cuda"]["count"]),
               mask_true=int(out["cuda"]["mask"].sum()))
    emit("lmac_cpu_cuda", **rec)
    if differ or rec["mask_true"] <= 0:
        raise AssertionError(f"lmac sources differ between the card and the "
                             f"CPU in {differ}")
    return rec


def lmac_layer_ms(tree, warm_ms: float) -> dict:
    """Phase lmac_layers: a warm lmac+grid2 query split between device
    syncs: the slices' group pre-filter, the chunks' predicate and
    materialisation, the kernel call (active-block lists, K1c, the G
    scale), the L2P of the kept leaf locals, the rest."""
    from rakau_tpu_torch import engine, grid2, traversal3
    from rakau_tpu_torch.kernels import dispatch
    tree.accs_pots_o(THETA)     # the tree's state back into the engine's
    #                             two-tree cache, after the other trees
    t, total = synced_layers(tree, ((traversal3, "build_group_candidates"),
                                    (traversal3, "build_shared_sources"),
                                    (engine, "_chunk_sources"),
                                    (dispatch, "eval_shared"),
                                    (grid2, "l2p_particles")))
    out = {"warm_query_ms": warm_ms,
           "group_prefilter_ms": t["build_group_candidates"],
           "predicate_ms": t["build_shared_sources"],
           "chunk_rest_ms": t["_chunk_sources"] - t["build_shared_sources"],
           "kernel_call_ms": t["eval_shared"], "l2p_ms": t["l2p_particles"],
           "synced_query_ms": total}
    out["rest_ms"] = total - t["build_group_candidates"] \
        - t["_chunk_sources"] - t["eval_shared"] - t["l2p_particles"]
    return out


def lmac_main(pos, mass, oracle, dev):
    """Phase lmac: the reference's lmac1m configuration (LMAC_KW), caps
    grown by the Tree and fitted by tune_caps; once cold, WARM_REPS times
    warm: K1c (mono_cell) launches = live chunks and no other form; the
    group table's row count (maxima slot 2) above 0 and under its cap;
    the accuracy bounds, and force RMS at most LMAC_SHARED_RATIO x the
    shared engine's with the same far field, level and theta on the same
    particles. Then its layers, profile, variants, K6's cell forms on its
    chunks and its density. Returns the tree's config, the K6 cell forms
    and launches, and the record."""
    from rakau_tpu_torch import Tree, engine, grid2
    from rakau_tpu_torch.config import OVF_FIELDS, TreeConfig
    n = pos.shape[0]
    cfg0 = TreeConfig(**LMAC_KW)
    tree, build_ms = synced_ms(lambda: Tree(coords=pos, masses=mass,
                                            config=cfg0))
    _, cold_ms = event_ms(lambda: tree.accs_pots_o(THETA))
    grown = {f: getattr(tree.config, f) for f in OVF_FIELDS}
    tree.tune_caps()
    _, settle_ms = event_ms(lambda: tree.accs_pots_o(THETA))
    td, cfg = tree.tree_data, tree.config
    chunks = engine.live_chunks(td, cfg)
    (acc, pot), warm, counts = warm_counted(tree, WARM_REPS)
    for c in counts:
        k1_launches(c, query_chunks(td, cfg), ("mono_cell",),
                    "lmac warm query")
    if acc.shape != (n, 3) or pot.shape != (n,):
        raise AssertionError(f"bad shapes {acc.shape} {pot.shape}")
    finite("lmac accelerations or potentials", acc, pot)
    f_rms, p_rms = sampled_rms(acc, pot, *oracle, dev)
    _, _, ovf, mx = engine.acc_pot_u_host(td, cfg, THETA, 0.0)
    ovf, mx = ovf.cpu().tolist(), mx.cpu().tolist()
    warm_ms = statistics.median(warm)
    rec = dict(n=n, theta=THETA, farfield="grid2", local_order=4, grid_sep=2,
               grid_level=grid2.effective_grid_level(cfg, n),
               build_ms=build_ms, cold_query_ms=cold_ms, caps_grown=grown,
               caps={f: getattr(cfg, f) for f in OVF_FIELDS},
               first_query_after_tune_ms=settle_ms, warm_query_ms=warm_ms,
               warm_query_ms_all=warm,
               warm_spread=(max(warm) - min(warm)) / warm_ms,
               n_tiles=int(td.n_tiles), chunks=chunks,
               slices=engine._slices(chunks, cfg.tile_chunk),
               launches_per_warm_query=[c["K1"]["mono_cell"]
                                        for c in counts],
               maxima=mx, overflow=ovf, evals_per_s=n / (warm_ms / 1e3),
               force_rms=f_rms, pot_rms=p_rms)

    # the shared engine beside it: same far field, level and theta
    stree = Tree(coords=pos, masses=mass, config=cfg0.with_(
        traversal_mode="shared", frontier_cap=TREE_KW["frontier_cap"]))
    (sacc, spot), s_ms = synced_ms(lambda: stree.accs_pots_o(THETA))
    s_f, s_p = sampled_rms(sacc, spot, *oracle, dev)
    rec.update(shared_force_rms=s_f, shared_pot_rms=s_p,
               shared_first_query_ms=s_ms, shared_grid_level=
               grid2.effective_grid_level(stree.config, n),
               force_rms_over_shared=f_rms / s_f)
    del stree, sacc, spot
    emit("lmac", **rec)
    if any(ovf) or not 0 < mx[2] < cfg.frontier_cap:
        raise AssertionError(f"lmac group table: maxima {mx}, overflow "
                             f"{ovf}, cap {cfg.frontier_cap}")
    if not (f_rms < FORCE_RMS_MAX and p_rms < POT_RMS_MAX):
        raise AssertionError(f"lmac accuracy: force rms {f_rms:.3e}, pot "
                             f"rms {p_rms:.3e}")
    if not f_rms <= LMAC_SHARED_RATIO * s_f:
        raise AssertionError(f"lmac force rms {f_rms:.3e} above "
                             f"{LMAC_SHARED_RATIO} x the shared engine's "
                             f"{s_f:.3e}")
    emit("lmac_layers", **lmac_layer_ms(tree, warm_ms))
    emit("lmac_profile", **profile_record(
        device_profile(tree, "shared_fused_", "k1c_device_ms"),
        warm_ms))
    rec["graphs"] = graph_ab(tree, "lmac+grid2",
                             {"K1": {"mono_cell": query_chunks(td, cfg)}},
                             "shared_fused_", "k1c_device_ms")
    vrec, v_launches = variant_queries(tree, oracle, (f_rms, p_rms),
                                       "mma_cell", dev)
    emit("variants", config="lmac+grid2", **vrec)
    forms = variant_kernels(tree, n, "lmac+grid2")
    density(tree, "lmac+grid2")
    return cfg, forms, v_launches, rec


def lmac_gate(seed: int, dev) -> dict:
    """Phase lmac_gate: the reference's accuracy gate (GATE_KW at GATE_N
    particles, theta GATE_THETA): sampled force RMS at most
    GATE_FORCE_RMS_MAX against the float64 direct sum; per chunk one
    launch of the quadrupole cell form (node rows) and one of the monopole
    cell form (particle rows), both compensated."""
    from rakau_tpu_torch import Tree, direct_acc_pot_np, engine, particles
    from rakau_tpu_torch.config import OVF_FIELDS, TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(GATE_N, generator=gen)
    samp = np.sort(np.random.default_rng(seed + 1).choice(GATE_N, 256,
                                                          replace=False))
    acc_o, pot_o = direct_acc_pot_np(pos.double().cpu().numpy(),
                                     mass.double().cpu().numpy(),
                                     targets=samp)
    tree = Tree(coords=pos, masses=mass, config=TreeConfig(**GATE_KW))
    _, cold_ms = event_ms(lambda: tree.accs_pots_o(GATE_THETA))
    (acc, pot), ms, counts = warm_counted(tree, 1, GATE_THETA)
    chunks = query_chunks(tree.tree_data, tree.config)
    k1_launches(counts[0], chunks, ("quad_comp_cell", "mono_comp_cell"),
                "lmac gate query")
    finite("lmac gate result", acc, pot)
    f_rms, p_rms = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
    rec = dict(n=GATE_N, theta=GATE_THETA, local_order=6, grid_sep=3,
               multipole_order=2, accum="compensated", chunks=chunks,
               caps={f: getattr(tree.config, f) for f in OVF_FIELDS},
               cold_query_ms=cold_ms, warm_query_ms=ms[0], force_rms=f_rms,
               pot_rms=p_rms, launches={f: v for f, v in
                                        counts[0]["K1"].items() if v})
    emit("lmac_gate", **rec)
    if not f_rms <= GATE_FORCE_RMS_MAX:
        raise AssertionError(f"lmac gate: force rms {f_rms:.3e} above "
                             f"{GATE_FORCE_RMS_MAX}")
    return rec


def leapfrog(n: int, seed: int, dev):
    """BASELINE config #2 on the card through rakau_tpu_torch.integrate
    (phase 9). Returns the phase's record and the energy tree and config
    for the kernel phase."""
    from rakau_tpu_torch import Tree, build, engine, integrate, particles
    from rakau_tpu_torch.config import OVF_FIELDS, TreeConfig
    from rakau_tpu_torch.kernels import shared

    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.cold_sphere(n, generator=gen)
    state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)
    cfg = TreeConfig(**LF_KW)
    ecfg0 = cfg.with_(multipole_order=2, accum="compensated",
                      farfield="m2p")
    rec = {"n": n, "steps": LF_STEPS, "dt": LF_DT, "theta": LF_THETA,
           "energy_theta": E_THETA, "eps": LF_EPS, "box": LF_BOX}
    # the step's build graphed against eager, first (it empties the graph
    # cache to time a first call)
    build_rec = build_ab(pos, mass, cfg, LF_BOX, "config #2")

    def launches_of(fn):
        """(fn(), wall ms, K1's launches per form, graphs captured): the
        call timed and counted, then once more under the profiler
        (measured), whose launches the timed call's must equal."""
        (out, ms), counts = counted(lambda: synced_ms(fn))
        captures = engine._GRAPHS.captures
        _, counts = measured(fn, want=counts)
        return out, ms, counts["K1"], captures

    # size the energy query's caps through the Tree API (grow and retry);
    # E3's state has moved a little, so no cap stays below 1.25x the
    # maxima this query measured (caps only grow)
    etree = Tree(coords=pos, masses=mass, config=ecfg0, box_size=LF_BOX)
    _, size_ms = synced_ms(lambda: etree.pots_o(E_THETA, LF_EPS))
    grown = etree.config
    fitted = etree.tune_caps(slack=1.25)
    ecfg = grown.with_(**{f: max(getattr(grown, f), getattr(fitted, f))
                          for f in OVF_FIELDS})
    rec.update(energy_caps_sizing_ms=size_ms,
               energy_caps_grown={f: getattr(grown, f) for f in OVF_FIELDS},
               energy_caps={f: getattr(ecfg, f) for f in OVF_FIELDS})

    def energy(st, td):
        """(energy, ms, chunks, K1's launches, graphs captured): the
        config's energy query, total_energy_host as benchmarks/configs.py
        calls it."""
        e, ms, launches, captures = launches_of(
            lambda: integrate.total_energy_host(st, ecfg, E_THETA, LF_EPS,
                                                box_size=LF_BOX))
        chunks = query_chunks(td, ecfg)
        if not (launches["quad_comp"] == launches["mono_comp"] == chunks
                and launches["mono"] == launches["quad"] == 0):
            raise AssertionError(f"energy query launches {launches}, "
                                 f"chunks {chunks}")
        if not np.isfinite(e):
            raise AssertionError(f"energy {e} is not finite")
        return e, ms, chunks, launches, captures

    # the energy query's graphs are captured once, before it is counted;
    # the second query (E0) must capture nothing
    integrate.total_energy_host(state, ecfg, E_THETA, LF_EPS,
                                box_size=LF_BOX)
    e0, e0_ms, e_chunks, e_launches, e0_captures = energy(state,
                                                          etree.tree_data)
    rec.update(e0=e0, energy_query_ms=e0_ms, energy_chunks=e_chunks,
               energy_launches=e_launches, e0_captures=e0_captures)

    step_ms, retries, caps_grown, step_captures = [], 0, [], []
    step_launches = dict.fromkeys(shared.launches, 0)
    for _ in range(LF_STEPS):
        ((state, ovf, _, cfg, r), ms), counts = counted(lambda: synced_ms(
            lambda: integrate.leapfrog_step_morton_host_safe(
                state, LF_DT, cfg, LF_THETA, LF_EPS, box_size=LF_BOX)))
        step_ms.append(ms)
        step_captures.append((engine._GRAPHS.captures, r))
        retries += r
        if r:
            caps_grown.append({f: getattr(cfg, f) for f in OVF_FIELDS})
        for f, v in counts["K1"].items():
            step_launches[f] += v
    # a steady-state step (the third, where no cap grew) captures nothing
    if e0_captures or (step_captures[-1][0] and not step_captures[-1][1]):
        raise AssertionError(f"leapfrog: steady-state captures: energy "
                             f"{e0_captures}, steps {step_captures}")
    if step_launches["mono"] <= 0 or any(
            step_launches[f] for f in ("mono_comp", "quad", "quad_comp")):
        raise AssertionError(f"leapfrog step launches {step_launches}")
    for t in state:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite leapfrog state")
    td, build_ms = synced_ms(lambda: build.build_tree(
        state.pos, state.mass, cfg, LF_BOX))
    _, query_ms = synced_ms(lambda: engine.acc_pot_u_host(
        td, cfg, LF_THETA, LF_EPS))
    rec.update(step_ms_median=statistics.median(step_ms), step_ms_all=step_ms,
               step_build_ms=build_ms, step_query_ms=query_ms,
               step_chunks=engine.live_chunks(td, cfg),
               cap_retries=retries, caps_grown_to=caps_grown,
               step_launches=step_launches,
               step_captures=[c for c, _ in step_captures])

    td3 = build.build_tree(state.pos, state.mass, ecfg, LF_BOX)
    e3, e3_ms, _, _, e3_captures = energy(state, td3)
    drift = abs(e3 - e0) / abs(e0)
    rec.update(e3=e3, energy_query_ms_e3=e3_ms, drift=drift,
               e3_captures=e3_captures)
    # the step three ways and the energy two ways on a smaller sphere
    sp, sm = particles.cold_sphere(
        min(SMALL_N, n),
        generator=torch.Generator(device=dev).manual_seed(seed + 3))
    small = integrate.NBodyState(sp, torch.zeros_like(sp), sm)
    rec["graphs"] = {"leapfrog_step": step_three_ways(small, cfg),
                     "total_energy": energy_two_ways(small, ecfg),
                     "build config #2": build_rec}
    del small, sp, sm

    # sampled accuracy of the final state against the float64 direct sum
    samp = np.sort(np.random.default_rng(seed + 1).choice(n, 256,
                                                          replace=False))
    acc_o, pot_o, o_check = sampled_oracle(state.pos, state.mass, samp,
                                           LF_EPS)
    acc, pot, ovf = integrate.acc_pot_host(state.pos, state.mass, cfg,
                                           LF_THETA, LF_EPS, box_size=LF_BOX)
    f_rms, p_rms = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
    _, epot, eovf = integrate.acc_pot_host(state.pos, state.mass, ecfg,
                                           E_THETA, LF_EPS, box_size=LF_BOX)
    _, e_rms = sampled_rms(None, epot, None, pot_o, samp, dev)
    # the same energy query with fp32 sums (K1d), beside it
    qtree = Tree(coords=state.pos, masses=state.mass,
                 config=ecfg.with_(accum="fp32"), box_size=LF_BOX)
    qtree.pots_o(E_THETA, LF_EPS)       # captures its graphs
    qpot, q_ms, q_launches, _ = launches_of(lambda: qtree.pots_o(E_THETA,
                                                                 LF_EPS))
    _, q_rms = sampled_rms(None, qpot, None, pot_o, samp, dev)
    rec.update(oracle_check=o_check, force_rms=f_rms, pot_rms=p_rms,
               energy_pot_rms=e_rms,
               fp32_quad_pot_rms=q_rms, fp32_quad_query_ms=q_ms,
               fp32_quad_launches=q_launches)
    emit("leapfrog", **rec)
    if ovf.any() or eovf.any():
        raise AssertionError("accuracy queries overflowed their caps")
    for t in (acc, pot, epot, qpot):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite accuracy query result")
    if q_launches["quad"] <= 0 or q_launches["quad_comp"]:
        raise AssertionError(f"fp32 quadrupole launches {q_launches}")
    if not drift < DRIFT_MAX:
        raise AssertionError(f"energy drift {drift:.3e} >= {DRIFT_MAX}")
    if not (f_rms < LF_FORCE_RMS_MAX and p_rms < LF_POT_RMS_MAX
            and e_rms < E_POT_RMS_MAX):
        raise AssertionError(f"leapfrog accuracy: force rms {f_rms:.3e}, "
                             f"pot rms {p_rms:.3e}, energy-config pot rms "
                             f"{e_rms:.3e}")
    return rec, etree, ecfg


def energy_kernels(etree, ecfg, forms=("quad_comp", "quad", "mono_comp"),
                   label: str = "energy"):
    """Phase 10: the energy query's first chunk, node rows [0, U) through
    K1d+K1b (and K1d) and particle rows [U, S) through K1b, against plain
    PyTorch in every mode, both timed (the kernel line says `label`; forms:
    the ones to run). Returns per form (worst error, ms, plain_ms,
    bound_ms, bound_by) of mode both."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import shared
    td = etree.tree_data
    n = int(td.pos.shape[0])
    inputs = engine.kernel_inputs(td, ecfg, E_THETA, LF_EPS, 0)
    quad = inputs[6]
    U = quad.shape[0]
    nodes = tuple(t[:U] for t in inputs[2:5])
    parts = tuple(t[U:] for t in inputs[2:5])
    mask = inputs[5]
    segs = {
        "quad_comp": (inputs[:2] + nodes + (mask[:, :U].contiguous(),),
                      dict(compensated=True, src_quad=quad)),
        "quad": (inputs[:2] + nodes + (mask[:, :U].contiguous(),),
                 dict(compensated=False, src_quad=quad)),
        "mono_comp": (inputs[:2] + parts + (mask[:, U:].contiguous(),),
                      dict(compensated=True)),
    }
    out, modes, shapes = {}, {}, {}
    for form in forms:
        args, kw = segs[form]
        worst = 0.0
        for mode in ("both", "acc", "pot"):
            got = shared.eval_shared_fused(
                *args, scal(LF_EPS, 1.0, args[0]), mode=mode, **kw)
            want = shared.eval_shared_plain(
                *args, scal(LF_EPS, 1.0, args[0]), mode=mode, **kw)
            err = compare(got, want)
            worst = max(worst, err)
            km = cuda_ms(lambda: shared.eval_shared_fused(
                *args, scal(LF_EPS, 1.0, args[0]), mode=mode, **kw), 10)
            pm = cuda_ms(lambda: shared.eval_shared_plain(
                *args, scal(LF_EPS, 1.0, args[0]), mode=mode, **kw), 1)
            modes.setdefault(form, {})[mode] = {"ms": km, "plain_ms": pm,
                                                "max_abs_err": err}
        b_ms, b_by = bound(args + ((quad,) if "quad" in form else ()), n,
                           quad="quad" in form, comp="comp" in form)
        out[form] = dict(max_abs_err=worst, ms=modes[form]["both"]["ms"],
                         plain_ms=modes[form]["both"]["plain_ms"],
                         bound_ms=b_ms, bound_by=b_by)
        shapes[form] = dict(k1_shape(args, "comp" in form, "quad" in form),
                            pct_of_bound=100 * b_ms / out[form]["ms"])
    C, T, _ = inputs[0].shape
    emit("kernel", config=label, chunk=0, C=C, T=T, U=U,
         S=int(inputs[2].shape[0]), shapes=shapes, modes=modes,
         bounds={f: (v["bound_ms"], v["bound_by"]) for f, v in out.items()})
    return out


def staircase(dev, dtype, kernel: str) -> dict:
    """The compensated forms of K1 or K2 in dtype on a row whose fp sums
    round the same way at every block: four targets at the origin, one
    source of mass 1 at distance 1 in the first block, then one of mass
    0.75 u (u: the spacing of dtype above 1) in each of the next 63 blocks
    (spans of SPAN granules, whose sums the reduction adds; K2's pool
    blocks of GRANULE x SPAN rows are one span, or two spans of the
    quadrupole's QUAD_SPAN, the second adding an exact zero), all at
    distance 1 along x (inv_r = 1; every other row
    massless). The exact sums are -(1 + 47.25 u) (potential) and
    1 + 47.25 u (x acceleration): fp sums round up by a quarter u at each
    block (error 15.75 u), TwoSum keeps the remainders (0.25 u after the
    last rounding). Raises unless every compensated error is at most 2 u and
    below a quarter of the fp one. Returns the errors in units of u, per
    form (monopole, and the quadrupole forms with zero moments)."""
    from fractions import Fraction
    from rakau_tpu_torch.kernels import pool, shared
    u = torch.finfo(dtype).eps
    block = (shared.GRANULE * shared.SPAN if kernel == "K1"
             else pool.GRANULE * pool.SPAN)
    S, T = 64 * block, 4
    tgt = torch.zeros((1, T, 3), dtype=dtype, device=dev)
    tidx = torch.arange(T, device=dev)[None]
    src = torch.zeros((S, 3), dtype=dtype, device=dev)
    src[:, 0] = 1
    mass = torch.zeros(S, dtype=dtype, device=dev)
    mass[block::block] = 0.75 * u
    mass[0] = 1
    sidx = torch.full((S,), -1, dtype=torch.int64, device=dev)
    exact = 1 + Fraction(189, 4) * Fraction(u)
    errs = {}
    for quad in (False, True):
        q = torch.zeros((S, 6), dtype=dtype, device=dev) if quad else None
        for comp in (False, True):
            if kernel == "K1":
                acc, pot = shared.eval_shared_fused(
                    tgt, tidx, src, mass, sidx,
                    torch.ones((1, S), dtype=torch.bool, device=dev),
                    scal(0.0, 1.0, tgt), compensated=comp, src_quad=q)
            else:
                sched = torch.tensor([[0, 0, 64, 0] if quad else
                                      [0, 0, 0, 64]], device=dev)
                acc, pot = pool.eval_pool_fused(
                    tgt, tidx, src, mass, sidx, sched, S, scal(0.0, 1.0, tgt),
                    block, compensated=comp, pool_quad=q)
            err = max(abs(Fraction(float(acc[0, 0, 0])) - exact),
                      abs(Fraction(float(pot[0, 0])) + exact))
            errs[("quad" if quad else "mono") + ("_comp" if comp else "")] \
                = float(err / Fraction(u))
        f = "quad" if quad else "mono"
        if not (errs[f + "_comp"] <= 2
                and errs[f + "_comp"] < errs[f] / 4):
            raise AssertionError(f"{kernel} {f} {dtype}: compensated error "
                                 f"{errs[f + '_comp']} u, fp sums "
                                 f"{errs[f]} u")
    return errs


def tiles_case(rng, C, T, Sm, Sp, ndim, pad, n=10000):
    """Rows for K3 and K4: per tile an M2P row and a P2P row with counts
    (tile 0: the whole rows; tile 1, where C > 1: 0 and 0; the others
    random, as a rule not multiples of BLOCK), padding past the counts at
    `pad` (1e30, or a 4 * box sentinel) with mass 0 and index -1, self
    pairs planted at the head of each P2P row, the last 5 targets padding
    (index n), and node 1 of tile 0 exactly on target 2."""
    tpos = rng.standard_normal((C, T, ndim)).astype(np.float32)
    tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int64)
    tidx[:, -5:] = n
    mpos = (3 * rng.standard_normal((C, Sm, ndim))).astype(np.float32)
    mmass = rng.uniform(0.1, 1, (C, Sm)).astype(np.float32)
    ppos = rng.standard_normal((C, Sp, ndim)).astype(np.float32)
    pmass = rng.uniform(0.1, 1, (C, Sp)).astype(np.float32)
    pidx = rng.integers(0, n, (C, Sp)).astype(np.int64)
    mcnt = rng.integers(1, Sm + 1, C).astype(np.int64)
    pcnt = rng.integers(1, Sp + 1, C).astype(np.int64)
    mcnt[0], pcnt[0] = Sm, Sp
    if C > 1:
        mcnt[1] = pcnt[1] = 0
    k = min(4, Sp)
    ppos[:, :k] = tpos[:, :k]
    pidx[:, :k] = tidx[:, :k]
    mpos[0, min(1, Sm - 1)] = tpos[0, 2]
    for pos, mass, cnt, idx in ((mpos, mmass, mcnt, None),
                                (ppos, pmass, pcnt, pidx)):
        dead = np.arange(pos.shape[1])[None] >= cnt[:, None]
        pos[dead] = pad
        mass[dead] = 0
        if idx is not None:
            idx[dead] = -1
    return (tpos, tidx, mpos, mmass, mcnt, ppos, pmass, pidx, pcnt)


def k3(args, eps, G, plain=False):
    """K3 (or its plain version) on (tgt_pos, tgt_idx, m2p_pos, m2p_mass,
    m2p_cnt, p2p_pos, p2p_mass, p2p_idx, p2p_cnt)."""
    from rakau_tpu_torch.kernels import tiles
    tp, ti, mp, mm, mc, pp, pm, pi, pc = args
    fn = tiles.eval_tiles_plain if plain else tiles.eval_tiles_fused
    return fn(tp, ti, mp, mm, pp, pm, pi, scal(eps, G, tp), m2p_cnt=mc,
              p2p_cnt=pc)


def k4(args, eps, G, plain=False):
    """K4 as `pallas.eval_tiles(fused=False)` runs it: one launch a row
    (M2P without, P2P with the index test), the sums added and times G;
    with plain, the plain versions of the same on the same tensors."""
    from rakau_tpu_torch.kernels import tiles
    tp, ti, mp, mm, mc, pp, pm, pi, pc = args
    fn = tiles.eval_pairwise_plain if plain else tiles.eval_pairwise
    s = scal(eps, G, tp)
    am, pmo = fn(tp, ti, mp, mm, None, s, False, cnt=mc)
    ap, ppo = fn(tp, ti, pp, pm, pi, s, True, cnt=pc)
    return G * (am + ap), G * (pmo + ppo)


TILES_EDGE = ((4, 200, 3000, 2500, 3, 0.0, 1e30),
              (3, 77, 1024, 2048, 3, 0.05, 40.0),
              (2, 512, 700, 5000, 3, 0.0, 40.0),
              (2, 130, 10, 1, 3, 0.0, 1e30),
              (3, 100, 1500, 1200, 2, 0.01, 1e30))


def tiles_plans_equal(args) -> bool:
    """The plan K3's kernel builds on these rows equals tiles_plan's."""
    from rakau_tpu_torch.kernels import tiles
    C, Sm, Sp = args[0].shape[0], args[2].shape[1], args[5].shape[1]
    return same_rows_plan(tiles.tiles_device_plan(C, Sm, Sp, args[4],
                                                  args[8]),
                          tiles.tiles_plan(C, Sm, Sp, args[4], args[8]))


def pairwise_plans_equal(C: int, S: int, cnt, block: int) -> bool:
    """The plan K4's kernel builds for one row equals pairwise_plan's."""
    from rakau_tpu_torch.kernels import tiles
    return same_rows_plan(tiles.pairwise_device_plan(C, S, cnt, block),
                          tiles.pairwise_plan(C, S, cnt, block))


def k4_row_cases(args, eps, dtype) -> float:
    """K4 launched on one row at a time, each row of tiles_case's tiles:
    the M2P row without indices, the P2P row with them, at blocks of 64,
    200 (not a multiple of the granule) and BLOCK, with the rows' counts
    and with counts past S, negative, 0 and ending before the row's live
    entries (mass past the count inside a visited block, which K4 reads);
    each launch twice bit for bit and against its plain version, the
    plan its kernel builds equal to pairwise_plan's. Returns the worst
    |kernel - plain|."""
    from rakau_tpu_torch.kernels import tiles
    tp, ti, mp, mm, mc, pp, pm, pi, pc = args
    worst = 0.0
    for pos, mass, idx, cnt in ((mp, mm, None, mc), (pp, pm, pi, pc)):
        C, S = mass.shape
        odd = cnt.clone()
        odd[0] = S + 50
        odd[-1] = cnt[-1] // 2
        if C > 2:
            odd[1], odd[2] = -3, 0
        for block in (64, 200, tiles.BLOCK):
            for k in (cnt, odd):
                if not pairwise_plans_equal(C, S, k, block):
                    raise AssertionError("K4: the kernel's plan differs "
                                         "from pairwise_plan's")
                kw = dict(cnt=k, block=block)
                got = tiles.eval_pairwise(
                    tp, ti, pos, mass, idx, scal(eps, 1.0, tp),
                    idx is not None, **kw)
                again = tiles.eval_pairwise(
                    tp, ti, pos, mass, idx, scal(eps, 1.0, tp),
                    idx is not None, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError("K4 (one row): two launches differ")
                want = tiles.eval_pairwise_plain(
                    tp, ti, pos, mass, idx, scal(eps, 1.0, tp),
                    idx is not None, **kw)
                worst = max(worst, compare(got, want, **tol(dtype)))
    return worst


def tiles_edge_cases(dev, dtype) -> dict:
    """K3 and K4 against their plain versions in dtype on made rows
    (tiles_case: counts of 0, of the whole row and not multiples of the
    granule or of BLOCK, self pairs in the P2P row, a node on a target at
    eps = 0, eps 0 and 0.05, ragged T, padding at 1e30 and at 4 * box,
    and a 2-D case), K3 against K4, K3 and K4 twice bit for bit, the
    plan K3's kernel builds equal to tiles_plan's; a tile whose counts are
    0 gets exact zeros from K3, and the node on the target adds nothing;
    then K4 one row a launch (k4_row_cases). Returns the worst
    |kernel - plain| of each and of K3 - K4."""
    rng = np.random.default_rng(23)
    worst = {"K3": 0.0, "K4": 0.0, "K3_vs_K4": 0.0, "K4_rows": 0.0}
    for C, T, Sm, Sp, ndim, eps, pad in TILES_EDGE:
        args = on_card(tiles_case(rng, C, T, Sm, Sp, ndim, pad), dev, dtype)
        if not tiles_plans_equal(args):
            raise AssertionError("K3: the kernel's plan differs from "
                                 "tiles_plan's")
        got3 = k3(args, eps, 1.5)
        if not all(torch.equal(a, b) for a, b in zip(got3,
                                                     k3(args, eps, 1.5))):
            raise AssertionError("K3: two launches differ")
        worst["K3"] = max(worst["K3"], compare(got3, k3(args, eps, 1.5, True),
                                               **tol(dtype)))
        got4 = k4(args, eps, 1.5)
        worst["K4"] = max(worst["K4"], compare(got4, k4(args, eps, 1.5, True),
                                               **tol(dtype)))
        worst["K3_vs_K4"] = max(worst["K3_vs_K4"],
                                compare(got4, got3, **tol(dtype)))
        if not all(torch.equal(a, b) for a, b in zip(got4,
                                                     k4(args, eps, 1.5))):
            raise AssertionError("K4: two launches differ")
        if C > 1 and bool(got3[0][1].any() | got3[1][1].any()):
            raise AssertionError("K3: a tile with empty rows got a nonzero "
                                 "result")
        worst["K4_rows"] = max(worst["K4_rows"],
                               k4_row_cases(args, eps, dtype))
        if eps == 0.0:
            off = list(args)
            off[3] = args[3].clone()
            off[3][0, min(1, Sm - 1)] = 0
            for fn in (k3, k4):
                a, b = fn(args, eps, 1.5), fn(off, eps, 1.5)
                if not (torch.equal(a[0][0, 2], b[0][0, 2])
                        and torch.equal(a[1][0, 2], b[1][0, 2])):
                    raise AssertionError(f"{fn.__name__}: a node on a "
                                         "target added something")
    return worst


def tiles_bound(args, n: int):
    """(bound_ms, bound_by) of one evaluation of the tile lists (K3, or
    K4's two launches: the same function): the bytes it must move (the
    targets and their indices, the counts, and of each row only the
    entries within its tile's count, read once; the outputs written once)
    over the HBM rate, and the operations of its live pairs (real targets
    x the entries within each tile's counts, 20 each) over the peak of the
    type (fp32 or fp64 outside the tensor cores). Entries past the counts
    are padding that the function need not read."""
    tp, ti, mp, mm, mc, pp, pm, pi, pc = args
    C, T, D = tp.shape
    real = tp.element_size()
    lm = mc.clamp(0, mp.shape[1]).double()
    lp = pc.clamp(0, pp.shape[1]).double()
    nbytes = (C * T * (D * real + ti.element_size())       # targets
              + mc.numel() * mc.element_size() + pc.numel() * pc.element_size()
              + float(lm.sum()) * (D + 1) * real           # pos, mass
              + float(lp.sum()) * ((D + 1) * real + pi.element_size())
              + C * T * (D + 1) * real)                    # acc, pot
    ntgt = (ti < n).sum(1).double()
    flops = float((ntgt * (lm + lp)).sum()) * FLOPS_MONO
    peak = PEAK_FP64 if tp.dtype == torch.float64 else PEAK_FP32
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                        else "operations")


def tiles_shape(args) -> dict:
    """K3's launch shape on one chunk's rows: the granules and spans of
    its plan (tiles.tiles_plan), its work items, the CUDA blocks of its
    persistent grid, the blocks that fit an SM, the warps an SM holds on
    average (4 a block, over the blocks that find an item) and the
    registers of its kernel (ptxas, build phase)."""
    from rakau_tpu_torch.kernels import shared, tiles
    tp, mc, pc = args[0], args[4], args[8]
    C, T, _ = tp.shape
    Sm, Sp = args[2].shape[1], args[5].shape[1]
    f64 = tp.dtype == torch.float64
    lib = shared._library("tiles", f64)
    plan = tiles.tiles_plan(C, Sm, Sp, mc, pc)
    sms = shared.multiprocessors(tp.device)
    grid = lib.rakau_tiles_grid(plan.work.shape[0], T, sms)
    items = int(plan.n_work[0]) * -(-T // (
        128 * lib.rakau_tiles_targets_per_thread()))
    gm, gp = tiles.tiles_granules(C, Sm, Sp, mc, pc)
    return dict(granules=int((gm + gp).sum()), span=tiles.SPAN,
                spans=int(plan.n_work[0]), work_items=items,
                cuda_blocks=grid,
                blocks_per_sm_fit=lib.rakau_tiles_blocks_per_sm(),
                warps_per_sm=4 * min(grid, items) / sms, sms=sms,
                registers=REGISTERS.get("tiles_f64" if f64 else "tiles", {})
                .get("tiles_fused_kernel"))


def pairwise_shape(args) -> dict:
    """K4's launch shape on one chunk's rows, its two launches summed: the
    granules and spans of their plans (tiles.pairwise_plan), their work
    items and the CUDA blocks of their persistent grids, the blocks that
    fit an SM, the warps an SM holds on average over a launch and the
    registers of its kernel (ptxas, build phase)."""
    from rakau_tpu_torch.kernels import shared, tiles
    tp = args[0]
    C, T, _ = tp.shape
    f64 = tp.dtype == torch.float64
    lib = shared._library("tiles", f64)
    sms = shared.multiprocessors(tp.device)
    out = dict(granules=0, span=tiles.SPAN, spans=0, work_items=0,
               cuda_blocks=0, warps=0)
    per_item = -(-T // (128 * lib.rakau_tiles_targets_per_thread()))
    for pos, cnt in ((args[2], args[4]), (args[5], args[8])):
        S = pos.shape[1]
        plan = tiles.pairwise_plan(C, S, cnt)
        grid = lib.rakau_tiles_pairwise_grid(plan.work.shape[0], T, sms)
        items = int(plan.n_work[0]) * per_item
        out["granules"] += int(tiles.pairwise_granules(C, S, cnt).sum())
        out["spans"] += int(plan.n_work[0])
        out["work_items"] += items
        out["cuda_blocks"] += grid
        out["warps"] += 4 * min(grid, items)
    out["warps_per_sm"] = out.pop("warps") / (2 * sms)
    return dict(out, sms=sms,
                blocks_per_sm_fit=lib.rakau_tiles_pairwise_blocks_per_sm(),
                registers=REGISTERS.get("tiles_f64" if f64 else "tiles", {})
                .get("tiles_pairwise_kernel"))


def tile_kernels(tree, n: int, label: str, theta: float, nchunks: int = 2,
                 with_k4: bool = True) -> dict:
    """Phase kernel for K3 (and K4) on the first `nchunks` chunks of
    `tree`'s lists query (engine.tile_kernel_inputs): each against its
    plain version and K4 against K3, CUDA-event ms per call beside the
    plain version's, the bound, the CUDA blocks against the SMs. Returns
    per kernel (worst error, mean ms, plain_ms, bound_ms, bound_by)."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import tiles
    td, cfg = tree.tree_data, tree.config
    dev = td.pos.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per: dict = {}
    for ch in range(min(nchunks, engine.live_chunks(td, cfg))):
        inp = engine.tile_kernel_inputs(td, cfg, theta, 0.0, ch)
        args = (inp[0], inp[1], inp[2], inp[3], inp[8], inp[5], inp[6],
                inp[7], inp[9])
        dt = args[0].dtype
        C, T, _ = args[0].shape
        Sm, Sp = int(args[2].shape[1]), int(args[5].shape[1])
        b_ms, b_by = tiles_bound(args, n)
        rec = dict(config=label, chunk=ch, C=C, T=T, Sm=Sm, Sp=Sp,
                   dtype=str(dt).replace("torch.", ""),
                   m2p_count_mean=float(args[4].double().mean()),
                   p2p_count_mean=float(args[8].double().mean()),
                   bound_ms=b_ms, bound_by=b_by, sms=sms)
        if not tiles_plans_equal(args):
            raise AssertionError(f"K3, {label} chunk {ch}: the kernel's "
                                 "plan differs from tiles_plan's")
        shape = tiles_shape(args)
        rec["K3_shape"] = shape
        runs = [("K3", k3, shape["cuda_blocks"])]
        if with_k4:
            if not all(pairwise_plans_equal(C, S, cnt, tiles.BLOCK)
                       for S, cnt in ((Sm, args[4]), (Sp, args[8]))):
                raise AssertionError(f"K4, {label} chunk {ch}: the kernel's "
                                     "plan differs from pairwise_plan's")
            rec["K4_shape"] = pairwise_shape(args)
            runs.append(("K4", k4, rec["K4_shape"]["cuda_blocks"]))
        got3 = None
        for name, fn, cuda_blocks in runs:
            got = fn(args, 0.0, 1.0)
            if not all(torch.equal(a, b) for a, b in zip(got,
                                                         fn(args, 0.0, 1.0))):
                raise AssertionError(f"{name}, {label} chunk {ch}: two "
                                     "launches differ")
            want = fn(args, 0.0, 1.0, True)
            err = compare(got, want, **tol(dt))
            if got3 is None:
                got3 = got
            else:
                rec["K4_vs_K3_max_abs_err"] = compare(got, got3, **tol(dt))
            km = cuda_ms(lambda: fn(args, 0.0, 1.0), 10)
            pm = cuda_ms(lambda: fn(args, 0.0, 1.0, True), 1)
            rec[name] = dict(ms=km, plain_ms=pm, max_abs_err=err,
                             cuda_blocks=cuda_blocks,
                             fill=cuda_blocks / sms,
                             pct_of_bound=100 * b_ms / km)
            per.setdefault(name, []).append(dict(
                max_abs_err=err, ms=km, plain_ms=pm, bound_ms=b_ms,
                bound_by=b_by))
        emit("kernel", **rec)
    return {name: dict(
        max_abs_err=max(r["max_abs_err"] for r in rs),
        ms=float(np.mean([r["ms"] for r in rs])),
        plain_ms=float(np.mean([r["plain_ms"] for r in rs])),
        bound_ms=float(np.mean([r["bound_ms"] for r in rs])),
        bound_by=max((r["bound_ms"], r["bound_by"]) for r in rs)[1])
        for name, rs in per.items()}


@contextmanager
def diag_modes():
    """RAKAU_DIAG_MODES=1 for the duration: the lists path and the
    quadrupole on it are diagnostic modes of the configuration, as in the
    reference."""
    import os
    prev = os.environ.get("RAKAU_DIAG_MODES")
    os.environ["RAKAU_DIAG_MODES"] = "1"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("RAKAU_DIAG_MODES", None)
        else:
            os.environ["RAKAU_DIAG_MODES"] = prev


def lists_layer_ms(tree) -> dict:
    """The lists query split by layer between device syncs: the walk
    (traversal.build_interaction_lists), the gather of the tiles' rows
    (engine._gather_sources) and the kernel call (dispatch.eval_tiles:
    K3 and the G scale). The rest is tile gathers, assembly, the overflow
    read and the inverse permutation."""
    from rakau_tpu_torch import engine, traversal
    from rakau_tpu_torch.kernels import dispatch
    t, total = synced_layers(tree, ((traversal, "build_interaction_lists"),
                                    (engine, "_gather_sources"),
                                    (dispatch, "eval_tiles")))
    out = {"walk_ms": t["build_interaction_lists"],
           "gather_ms": t["_gather_sources"],
           "kernel_call_ms": t["eval_tiles"]}
    out["rest_ms"] = total - sum(out.values())
    out["synced_query_ms"] = total
    return out


def lists_main(pos, mass, oracle, shared_rms, dev, small):
    """Phase lists: the main phase's particles through the lists path
    (LISTS_KW: the caps of TREE_KW, grown by the Tree's overflow retry),
    once cold and three times warm: K3 launches per warm query = live
    chunks and no other launch, force RMS < 5e-3 and potential < 2e-3
    beside the shared engine's; then lists_layers, lists_profile, the
    phase graphs on `small`'s particles (its point, equal sums and
    launches, holds at any N), the whole query once more on K4
    (lists_split: 2 launches a chunk, no K3, force RMS within
    VARIANT_RMS_RTOL of K3's) and the kernel phase on chunks 0 and 1.
    Returns the launches of each and the kernels' records."""
    from rakau_tpu_torch import Tree, engine
    from rakau_tpu_torch.config import OVF_FIELDS, TreeConfig
    from rakau_tpu_torch.kernels import dispatch
    n = pos.shape[0]
    tree, build_ms = synced_ms(lambda: Tree(coords=pos, masses=mass,
                                            config=TreeConfig(**LISTS_KW)))
    _, cold_ms = event_ms(lambda: tree.accs_pots_o(THETA))
    td, cfg = tree.tree_data, tree.config
    chunks = query_chunks(td, cfg)
    (acc, pot), warm, counts = warm_counted(tree, WARM_REPS)
    for c in counts:
        if c != launched(c, {"tiles": {"fused": chunks}}):
            raise AssertionError(f"lists warm query: launches {c}, want "
                                 f"{chunks} K3 and nothing else")
    if acc.shape != (n, 3) or pot.shape != (n,):
        raise AssertionError(f"bad shapes {acc.shape} {pot.shape}")
    finite("lists result", acc, pot)
    f_rms, p_rms = sampled_rms(acc, pot, *oracle, dev)
    warm_ms = statistics.median(warm)
    rec = dict(n=n, theta=THETA, farfield="m2p", build_ms=build_ms,
               caps_start={f: LISTS_KW[f] for f in OVF_FIELDS},
               caps={f: getattr(cfg, f) for f in OVF_FIELDS},
               maxima=tree._last_stats, cold_query_ms=cold_ms,
               warm_query_ms=warm_ms, warm_query_ms_all=warm,
               warm_spread=(max(warm) - min(warm)) / warm_ms, chunks=chunks,
               k3_launches_per_warm_query=[c["tiles"]["fused"]
                                           for c in counts],
               evals_per_s=n / (warm_ms / 1e3), force_rms=f_rms,
               pot_rms=p_rms, shared_force_rms=shared_rms[0],
               shared_pot_rms=shared_rms[1])
    emit("lists", **rec)
    if not (f_rms < FORCE_RMS_MAX and p_rms < POT_RMS_MAX):
        raise AssertionError(f"lists accuracy: force rms {f_rms:.3e}, pot "
                             f"rms {p_rms:.3e}")
    emit("lists_layers", warm_query_ms=warm_ms, **lists_layer_ms(tree))
    emit("lists_profile", **profile_record(
        device_profile(tree, K3_KERNELS, "k3_device_ms"), warm_ms))
    stree = Tree(coords=small[0], masses=small[1],
                 config=TreeConfig(**LISTS_KW))
    stree.accs_pots_o(THETA)            # its caps grown
    rec["graphs"] = graph_ab(stree, "lists", {"tiles": {"fused": query_chunks(
        stree.tree_data, stree.config)}}, K3_KERNELS, "k3_device_ms")
    rec["graphs"]["n"] = int(small[0].shape[0])
    del stree
    with dispatch.tiles_variant("split"):
        # the first query captures the variant's graphs; the second counts
        (acc4, pot4), ms4, c4 = warm_counted(tree, 2)
    if c4[-1] != launched(c4[-1], {"tiles": {"split": 2 * chunks}}):
        raise AssertionError(f"lists split query: launches {c4[-1]}, want "
                             f"{2 * chunks} K4 and nothing else")
    finite("lists split result", acc4, pot4)
    f4, p4 = sampled_rms(acc4, pot4, *oracle, dev)
    diff = float((acc4 - acc).abs().max() / acc.abs().max())
    emit("lists_split", warm_query_ms=ms4[-1],
         k4_launches=c4[-1]["tiles"]["split"], force_rms=f4, pot_rms=p4,
         max_rel_diff_to_k3=diff)
    if not abs(f4 - f_rms) < VARIANT_RMS_RTOL * f_rms:
        raise AssertionError(f"lists on K4: force rms {f4:.6e} is not "
                             f"within {VARIANT_RMS_RTOL} of K3's {f_rms:.6e}")
    forms = tile_kernels(tree, n, "lists", THETA)
    return {"K3": counts[-1]["tiles"]["fused"],
            "K4": c4[-1]["tiles"]["split"]}, forms, rec


def lists_quad(seed: int, dev) -> dict:
    """Phase lists_quad: LISTS_QUAD_N particles of a seeded Plummer sphere
    through the lists monopole (K3: launches = chunks), the quadrupole
    with farfield "local" (the lists path; its M2P row takes the
    reference's plain-op route: tiles.launches["xla_quad"] = chunks and no
    kernel launch), and shared+m2p with the quadrupole (K1d on the node
    rows, K1a on the particle rows). The lists quadrupole's force RMS must
    be below the lists monopole's and within LISTS_QUAD_RTOL of the shared
    quadrupole's."""
    from rakau_tpu_torch import Tree, engine, particles
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(LISTS_QUAD_N, generator=gen)
    samp = np.sort(np.random.default_rng(seed).choice(LISTS_QUAD_N, 256,
                                                      replace=False))
    acc_o, pot_o, o_check = sampled_oracle(pos, mass, samp)
    rec, rms = {"n": LISTS_QUAD_N, "theta": THETA,
                "oracle_check": o_check}, {}
    for key, kw in (("lists_mono", LISTS_KW),
                    ("lists_quad", dict(TREE_KW, farfield="local",
                                        multipole_order=2)),
                    ("shared_quad", dict(TREE_KW, farfield="m2p",
                                         multipole_order=2))):
        tree = Tree(coords=pos, masses=mass, config=TreeConfig(**kw))
        tree.accs_pots_o(THETA)
        (acc, pot), ms, counts = warm_counted(tree, 1)
        chunks = query_chunks(tree.tree_data, tree.config)
        want = {"lists_mono": {"tiles": {"fused": chunks}},
                "lists_quad": {"tiles": {"xla_quad": chunks}},
                "shared_quad": {"K1": {"quad": chunks, "mono": chunks}}}[key]
        if counts[-1] != launched(counts[-1], want):
            raise AssertionError(f"{key}: launches {counts[-1]}, want {want}")
        finite(key, acc, pot)
        rms[key] = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
        rec[key] = dict(warm_query_ms=ms[-1], chunks=chunks,
                        force_rms=rms[key][0], pot_rms=rms[key][1],
                        launches=want)
        del tree
    e_q, e_m, e_s = (rms[k][0] for k in ("lists_quad", "lists_mono",
                                         "shared_quad"))
    emit("lists_quad", **rec, quad_over_mono=e_q / e_m,
         quad_vs_shared=abs(e_q - e_s) / e_s)
    if not (e_q < e_m and abs(e_q - e_s) < LISTS_QUAD_RTOL * e_s):
        raise AssertionError(f"lists quadrupole force rms {e_q:.4e}: lists "
                             f"monopole {e_m:.4e}, shared quadrupole "
                             f"{e_s:.4e}")
    return rec


@contextmanager
def plain_forbidden():
    """Every plain version of a kernel raises for the duration: a query
    that runs inside it went through the kernels alone."""
    from rakau_tpu_torch.kernels import pool, shared, tiles
    names = ((shared, "eval_shared_plain"), (shared, "eval_shared_mma_plain"),
             (shared, "eval_shared_blocks_plain"), (pool, "eval_pool_plain"),
             (tiles, "eval_tiles_plain"), (tiles, "eval_pairwise_plain"))
    saved = [getattr(m, f) for m, f in names]

    def refuse(name):
        def fn(*a, **kw):
            raise AssertionError(f"the plain version {name} ran")
        return fn

    for m, f in names:
        setattr(m, f, refuse(f))
    try:
        yield
    finally:
        for (m, f), orig in zip(names, saved):
            setattr(m, f, orig)


def f1(seed: int, dev) -> tuple:
    """Phase f1: 2-D and float64 trees queried on the card, every launch
    on the kernels' 2-D (padded) or float64 forms, no plain version run
    (plain_forbidden), each against the float64 direct sum on 256
    sampled targets:
      2-D: quadtree(...) of F1_N particles uniform in a square, the shared
        engine with its default far field, theta 0.5: K1a launches =
        chunks, every one "d2"; force and potential RMS < 2e-2; the same
        with grid2 at level 10 (F1_2D_GRID2_KW): K1c launches = chunks,
        every one "d2", the same bounds, and K1c against its plain
        version on the last chunk, whose cells reach past 2^9;
      float64: octree(...) of F1_N Plummer particles given as NumPy
        float64 arrays (no dtype, no device), theta 0.4: K1a launches =
        chunks, every one "f64"; force RMS < 2e-3; then the same particles
        through gwalk (farfield "m2p", bench.py's gwalk caps tuned by
        tune_gwalk): one K2 launch, "f64"; and through the lists path
        (farfield "m2p"): K3 launches = chunks, "f64", and the same query
        under tiles_variant("split"): K4 launches = 2 x chunks, "f64";
        force RMS < 2e-3 each.
    Returns the record, the launches of each float64 form and their
    kernel records on chunk 0 (against the plain version)."""
    from rakau_tpu_torch import (Tree, direct_acc_pot_np, engine, octree,
                                 particles, quadtree)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rec, launches = {"n": F1_N}, {}
    samp = np.sort(np.random.default_rng(seed).choice(F1_N, 256,
                                                      replace=False))
    kw = dict(max_depth=14, max_leaf_n=32, ncrit=512, tile_chunk=32)

    def run(key, tree, theta, want, bounds):
        tree.accs_pots_o(theta)
        with plain_forbidden():
            (acc, pot), ms, counts = warm_counted(tree, 1, theta)
        chunks = query_chunks(tree.tree_data, tree.config)
        want = want(chunks)
        if counts[-1] != launched(counts[-1], want):
            raise AssertionError(f"f1 {key}: launches {counts[-1]}, want "
                                 f"{want}")
        finite(f"f1 {key}", acc, pot)
        pos_o = tree.positions_o.double().cpu().numpy()
        acc_o, pot_o = direct_acc_pot_np(pos_o, tree.masses_o.double().cpu()
                                         .numpy(), targets=samp)
        f_rms, p_rms = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
        rec[key] = dict(theta=theta, dtype=str(acc.dtype), chunks=chunks,
                        warm_query_ms=ms[-1], force_rms=f_rms, pot_rms=p_rms,
                        launches=want)
        if not (f_rms < bounds[0] and (bounds[1] is None
                                       or p_rms < bounds[1])):
            raise AssertionError(f"f1 {key}: force rms {f_rms:.3e}, pot rms "
                                 f"{p_rms:.3e}, bounds {bounds}")
        return want

    p2, m2 = particles.uniform_cube(F1_N, generator=gen, ndim=2)
    tree = quadtree(coords=p2, masses=m2, **kw)
    run("quadtree", tree, F1_2D_THETA,
        lambda c: {"K1": {"mono": c, "d2": c}}, (F1_2D_MAX, F1_2D_MAX))
    del tree
    from rakau_tpu_torch.kernels import dispatch, pool, shared
    tree = quadtree(coords=p2, masses=m2, **F1_2D_GRID2_KW, **kw)
    run("quadtree_grid2", tree, F1_2D_THETA,
        lambda c: {"K1": {"mono_cell": c, "d2": c}}, (F1_2D_MAX, F1_2D_MAX))
    td, cfg = tree.tree_data, tree.config
    inp = engine.kernel_inputs(td, cfg, F1_2D_THETA, 0.0,
                               engine.live_chunks(td, cfg) - 1)
    ckw = dict(src_cell=inp[7], tgt_cell=inp[8], grid_sep=cfg.grid_sep)
    top = int(max(inp[7].max(), inp[8].max()))
    if top < 1 << 9:
        raise AssertionError(f"f1 quadtree_grid2: cells reach {top} only")
    err = compare(shared.eval_shared_fused(
        *inp[:6], scal(0.0, 1.0, inp[0]), **ckw),
                  shared.eval_shared_plain(
                      *inp[:6], scal(0.0, 1.0, inp[0]), **ckw))
    rec["quadtree_grid2"].update(grid_level=F1_2D_GRID2_KW["grid_level"],
                                 max_cell=top, last_chunk_max_abs_err=err)
    del tree
    p64, m64 = particles.plummer(F1_N, generator=gen, dtype=torch.float64)
    p64, m64 = p64.cpu().numpy(), m64.cpu().numpy()
    tree = octree(coords=p64, masses=m64, **kw)
    launches["K1a"] = run("octree_f64", tree, F1_F64_THETA,
                          lambda c: {"K1": {"mono": c, "f64": c}},
                          (F1_F64_FORCE_MAX, None))["K1"]["f64"]
    td, cfg = tree.tree_data, tree.config
    inp = engine.kernel_inputs(td, cfg, F1_F64_THETA, 0.0, 0)[:6]
    got = shared.eval_shared_fused(*inp, scal(0.0, 1.0, inp[0]))
    err = compare(got, shared.eval_shared_plain(*inp, scal(0.0, 1.0, inp[0])),
                  **tol(torch.float64))
    b_ms, b_by = bound(inp, F1_N)
    forms = {"K1a": dict(
        max_abs_err=err, ms=cuda_ms(lambda: shared.eval_shared_fused(
            *inp, scal(0.0, 1.0, inp[0])), 10),
        plain_ms=cuda_ms(lambda: shared.eval_shared_plain(
            *inp, scal(0.0, 1.0, inp[0])),
                         1), bound_ms=b_ms, bound_by=b_by)}
    emit("kernel", config="octree_f64", form="mono", chunk=0,
         **forms["K1a"], **k1_shape(inp),
         pct_of_bound=100 * b_ms / forms["K1a"]["ms"])
    del tree
    from rakau_tpu_torch.config import TreeConfig
    gcfg = TreeConfig(farfield="m2p", dtype="float64", **gwalk_kw(F1_N))
    gtree, sizing = gwalk_tree(p64, m64, gcfg, F1_F64_THETA)
    launches["K2"] = run("gwalk_f64", gtree, F1_F64_THETA,
                         lambda c: {"K2": {"mono": 1, "f64": 1}},
                         (F1_F64_FORCE_MAX, None))["K2"]["f64"]
    rec["gwalk_f64"]["sizing"] = sizing
    gcfg_t = gtree.config
    inputs = engine.pool_inputs(gtree.tree_data, gcfg_t, F1_F64_THETA, 0.0)
    k2 = pool_kernels(inputs, F1_N, gcfg_t.pool_window, gcfg_t.pool_block,
                      ("mono",))["mono"]
    forms["K2"] = {k: v for k, v in k2.items() if k in KERNEL_KEYS}
    emit("kernel", config="gwalk_f64", **k2)
    del gtree
    with diag_modes():
        ltree = Tree(coords=p64, masses=m64,
                     config=TreeConfig(dtype="float64", **LISTS_KW))
        launches["K3"] = run("lists_f64", ltree, F1_F64_THETA,
                             lambda c: {"tiles": {"fused": c, "f64": c}},
                             (F1_F64_FORCE_MAX, None))["tiles"]["f64"]
        with dispatch.tiles_variant("split"):
            launches["K4"] = run(
                "lists_f64_split", ltree, F1_F64_THETA,
                lambda c: {"tiles": {"split": 2 * c, "f64": 2 * c}},
                (F1_F64_FORCE_MAX, None))["tiles"]["f64"]
        t_forms = tile_kernels(ltree, F1_N, "lists_f64", F1_F64_THETA,
                               nchunks=1)
        forms["K3"], forms["K4"] = t_forms["K3"], t_forms["K4"]
    del ltree
    emit("f1", **rec)
    return rec, launches, forms


# ---- phase multi: F2, the sharded query and step, the LET ---------------
MULTI_SHARDS = (1, 2, 4)
MULTI_EPS, MULTI_DT = 0.01, 1e-3
F2_RMS_MAX = 1e-5
# the reference's own tolerances: tests/test_sharded.py:50-67,
# tests/test_let.py:60-62 and :106, __graft_entry__.py:150
SHARD_RTOL, SHARD_ATOL_REL = 1e-5, 1e-6
STEP_POS_ATOL_REL, STEP_VEL_ATOL_REL = 1e-6, 1e-5
LET_SHARDS = 4
# The LET runs at a sixteenth of the main N: its Morton-range domain
# boxes overlap (on this Plummer sphere, and on config #4's uniform cube
# alike: the splitters cut a few cells off a neighbour's range, whose
# bounding box spans it), so a shard exports about its whole range to the
# domain that overlaps it (export counts of 64-66k of a shard's 65,536
# rows at 262,144), each shard imports ndev x export_cap rows, and the
# sizing runs the whole LET once per cap step. 262,144 until the whole
# twins' checks joined phase multi; cut to keep the script inside its
# time limit
LET_N = 65536
LET_CAPS = dict(export_cap=16384, export_node_cap=8192,
                export_part_cap=32768, export_leaf_cap=4096,
                export_frontier_cap=1024)      # acc_pot_let's defaults
LET_FORCE_FLOOR, LET_POT_MAX, LET_CROSS_MAX = 2e-3, 5e-3, 3e-3
LET_FORCE_RATIO = 1.5
# the accuracy engine through the LET (__graft_entry__.py:128-156), at
# F1_N particles on tests/test_let.py's tree shape. The exports are
# monopole macro-particles while the single-device query gives the same
# nodes their quadrupoles; that difference is what LET_ACC_DEV_MAX bounds,
# and it grows with the tiles (with the main path's ncrit 512 and
# max_depth 14 it exceeded the bound)
LET_ACC_KW = dict(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=16,
                  traversal_mode="lmac", farfield="m2p", multipole_order=2,
                  frontier_cap=4096)
LET_ACC_EPS, LET_ACC_BOX, LET_ACC_DEV_MAX = 0.05, 64.0, 5e-3
MULTI_TRIES = 8


def rel_rms(got, want) -> float:
    """RMS over particles of |got - want| / |want| (rows for vectors)."""
    got, want = got.double(), want.double()
    if got.dim() == 2:
        num, den = (got - want).norm(dim=1), want.norm(dim=1)
    else:
        num, den = (got - want).abs(), want.abs()
    return float(((num / den.clamp_min(1e-300)) ** 2).mean().sqrt())


def clear_of_overflow(fn, cfg, what: str):
    """fn(cfg) -> (result, overflow flags [4]); doubles the capacities
    whose flag is set until none is. Returns (result, cfg)."""
    from rakau_tpu_torch.config import grow_overflowed
    for _ in range(MULTI_TRIES):
        out, ovf = fn(cfg)
        if not bool(ovf.any()):
            return out, cfg
        cfg = grow_overflowed(cfg, ovf.tolist())
    raise AssertionError(f"multi {what}: overflow {ovf.tolist()} after "
                         f"{MULTI_TRIES} tries")


def f2_check(seed: int, dev) -> dict:
    """F2: kernel_backend is read. On F1_N Plummer particles (float32
    octree, shared+grid): the same query under "auto" and "xla"; "xla"
    makes no hand launch and agrees with "auto" to F2_RMS_MAX force RMS;
    "pallas" on a CPU copy of the tree raises ValueError."""
    from rakau_tpu_torch import engine, octree, particles
    from rakau_tpu_torch.parallel import mesh
    gen = torch.Generator(device=dev).manual_seed(seed)
    p, m = particles.plummer(F1_N, generator=gen)
    tree = octree(coords=p, masses=m, farfield="grid", max_depth=14,
                  max_leaf_n=32, ncrit=512, tile_chunk=32)
    tree.accs_pots_o(THETA)                 # the Tree fits its caps
    td, cfg = tree.tree_data, tree.config
    chunks = query_chunks(td, cfg)
    (auto, c_auto), ms_auto = synced_ms(lambda: counted(
        lambda: engine.acc_pot_u_host(td, cfg, THETA, 0.0)))
    (xla, c_xla), ms_xla = synced_ms(lambda: counted(
        lambda: engine.acc_pot_u_host(
            td, cfg.with_(kernel_backend="xla"), THETA, 0.0)))
    if c_auto != launched(c_auto, {"K1": {"mono": chunks}}):
        raise AssertionError(f"multi f2: auto launches {c_auto}")
    hand = {k: {f: v for f, v in c.items() if v and f != "xla_quad"}
            for k, c in c_xla.items()}
    if any(hand.values()):
        raise AssertionError(f"multi f2: xla made hand launches {hand}")
    f_rms, p_rms = rel_rms(xla[0], auto[0]), rel_rms(xla[1], auto[1])
    if not (f_rms <= F2_RMS_MAX and p_rms <= F2_RMS_MAX
            and torch.equal(xla[2], auto[2]) and not auto[2].any()):
        raise AssertionError(f"multi f2: xla vs auto force rms {f_rms:.3e}, "
                             f"pot rms {p_rms:.3e}, flags {xla[2]} "
                             f"{auto[2]}")
    try:
        engine.acc_pot_u_host(mesh.to_shards(mesh.default_mesh(
            device="cpu"), td)[0], cfg.with_(
            farfield="local", kernel_backend="pallas"), THETA, 0.0)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("multi f2: 'pallas' on CPU tensors ran")
    return dict(n=F1_N, chunks=chunks, auto_launches=c_auto["K1"]["mono"],
                xla_hand_launches=0, xla_vs_auto_force_rms=f_rms,
                xla_vs_auto_pot_rms=p_rms, auto_ms=ms_auto, xla_ms=ms_xla,
                pallas_on_cpu=refused)


def sharded_check(pos, mass, cfg, dev) -> tuple:
    """The tile-sharded query's _host twin on the main phase's particles,
    tree and caps at 1, 2 and 4 shards against the single-device query of
    the same config with farfield "local" (the sharded path's fallback
    from "grid"); then one leapfrog_step_sharded_host at 4 shards against
    integrate.leapfrog_step_host. Returns the record, the local config
    with the caps that held, and what the whole twins' checks compare
    with: the tree, the host twin's query result by shard count, the
    step's state and config."""
    from rakau_tpu_torch import build, engine, integrate
    from rakau_tpu_torch.parallel import sharded
    td = build.build_tree(pos, mass, cfg)

    def single(c):
        out, ms = synced_ms(lambda: engine.acc_pot_u_host(td, c, THETA, 0.0))
        return (out, ms), out[2]

    ((a1, p1, _, _), single_ms), cfg_l = clear_of_overflow(
        single, cfg.with_(farfield="local"), "single-device query")
    chunks = engine.live_chunks(td, cfg_l)
    cfg_g = cfg_l.with_(farfield="grid")
    a_tol = SHARD_ATOL_REL * float(a1.abs().max())
    p_tol = SHARD_ATOL_REL * float(p1.abs().max())
    rec = dict(n=pos.shape[0], chunks=chunks, single_query_s=single_ms / 1e3,
               caps={f: getattr(cfg_l, f) for f in
                     ("m2p_cap", "p2p_leaf_cap", "p2p_src_cap",
                      "frontier_cap")}, shards={})
    hosts = {}
    for k in MULTI_SHARDS:
        mesh = sharded.default_mesh(k)
        # the first query captures the shards' slice graphs; the second
        # is counted and timed
        sharded.acc_pot_u_sharded_host(td, cfg_g, THETA, 0.0, 1.0, mesh)
        ((a, p, o), counts), ms = synced_ms(lambda: counted(
            lambda: sharded.acc_pot_u_sharded_host(td, cfg_g, THETA, 0.0,
                                                   1.0, mesh)))
        hosts[k] = (a, p, o)
        # a third under the profiler: the launches it ran on the card
        _, counts = measured(lambda: sharded.acc_pot_u_sharded_host(
            td, cfg_g, THETA, 0.0, 1.0, mesh), want=counts)
        # the same chunk sums, each shard's slices replayed from graphs:
        # equal to the single-device query bit for bit
        ok = (not o.any()
              and torch.allclose(a, a1, rtol=SHARD_RTOL, atol=a_tol)
              and torch.allclose(p, p1, rtol=SHARD_RTOL, atol=p_tol)
              and torch.equal(a, a1) and torch.equal(p, p1))
        rec["shards"][k] = dict(
            query_s=ms / 1e3, k1a_launches=counts["K1"]["mono"],
            devices=[str(d) for d in mesh.devices],
            max_abs_diff_acc=float((a - a1).abs().max()),
            max_abs_diff_pot=float((p - p1).abs().max()))
        # each shard's chunk loop evaluates its range's slices whole
        want = sum(engine.evaluated_chunks(b - a, cfg_g.tile_chunk)
                   for a, b in sharded.chunk_ranges(chunks, k) if b > a)
        rec["shards"][k]["chunk_evaluations"] = want
        if not ok or counts != launched(counts, {"K1": {"mono": want}}):
            raise AssertionError(f"multi sharded {k}: {rec['shards'][k]}, "
                                 f"flags {o.tolist()}, launches {counts}")
    state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)

    def step1(c):
        out, ms = synced_ms(lambda: integrate.leapfrog_step_host(
            state, MULTI_DT, c, THETA, MULTI_EPS))
        return (out[0], ms), out[1]

    (s1, ms1), cfg_s = clear_of_overflow(step1, cfg_l,
                                         "leapfrog_step_host")
    mesh = sharded.default_mesh(LET_SHARDS)
    (s4, o4), ms4 = synced_ms(lambda: sharded.leapfrog_step_sharded_host(
        state, MULTI_DT, cfg_s, THETA, MULTI_EPS, 1.0, mesh))
    d_pos = float((s4.pos - s1.pos).abs().max())
    d_vel = float((s4.vel - s1.vel).abs().max())
    rec["leapfrog"] = dict(shards=LET_SHARDS, dt=MULTI_DT, eps=MULTI_EPS,
                           step_s=ms1 / 1e3, sharded_step_s=ms4 / 1e3,
                           max_abs_diff_pos=d_pos, max_abs_diff_vel=d_vel)
    if (o4.any() or d_pos > STEP_POS_ATOL_REL * float(s1.pos.abs().max())
            or d_vel > STEP_VEL_ATOL_REL * float(s1.vel.abs().max())):
        raise AssertionError(f"multi leapfrog: {rec['leapfrog']}, flags "
                             f"{o4.tolist()}")
    return rec, cfg_l, (td, cfg_g, hosts, state, cfg_s)


# warm calls of each way in the multi phase's whole-against-_host LET
# comparison (in turns; the query and the step take STEP_REPS)
LET_REPS = 2


def padded_chunks(td, cfg, k: int) -> int:
    """The chunks that the whole sharded query evaluates on k shards: the
    tile capacity's, padded to a multiple of k."""
    from rakau_tpu_torch import engine
    nc = engine._gather_tiles(td, cfg)[0].shape[0]
    return nc + (-nc % k)


def sharded_whole(td, cfg_g, hosts: dict) -> dict:
    """Phase multi, the whole sharded query: sharded.acc_pot_u_sharded (one
    CUDA graph a call: every chunk of the tile capacity, padded to a
    multiple of the shards) on the main tree with "grid" (its fallback
    "local") at MULTI_SHARDS shards, against acc_pot_u_sharded_host
    (hosts[k]: its result in sharded_check) and engine.acc_pot_u run
    eagerly with "local". On one shard nothing is padded and the graph
    would be engine.acc_pot_u's again, so its body runs once eagerly
    (graph=False). For each k > 1: the first call (first_call), STEP_REPS
    warm calls each way in turns that capture nothing, and a profiled
    replay whose K1a launches on the card must be the padded chunks.
    Raises unless the sums are bit-equal to both and no flag is set.
    Returns the record."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.parallel import sharded
    cfg_l = cfg_g.with_(farfield="local")
    a1, p1, o1 = engine.acc_pot_u(td, cfg_l, THETA, 0.0, graph=False)
    rec = {"capacity_chunks": padded_chunks(td, cfg_l, 1)}
    for k in MULTI_SHARDS:
        mesh = sharded.default_mesh(k)
        args = (td, cfg_g, THETA, 0.0, 1.0, mesh)
        if k == 1:
            a, p, o = sharded.acc_pot_u_sharded(*args, graph=False)
            r = rec[k] = {
                "graph": False,
                "bit_equal_to_host": [bool(torch.equal(x, y))
                                      for x, y in zip((a, p, o), hosts[k])],
                "bit_equal_to_acc_pot_u": [bool(torch.equal(a, a1)),
                                           bool(torch.equal(p, p1))],
                "overflow": o.tolist()}
            if (not all(r["bit_equal_to_host"] + r["bit_equal_to_acc_pot_u"])
                    or o.any() or o1.any()):
                raise AssertionError(f"multi sharded whole {k}: {r}")
            continue
        ways = {"whole": lambda: sharded.acc_pot_u_sharded(*args),
                "host": lambda: sharded.acc_pot_u_sharded_host(*args)}
        ways["host"]()                  # its graphs, as a caller finds them
        out, first = first_call(ways["whole"])
        outs, ms, booked, captures = in_turns(ways, STEP_REPS,
                                              f"multi sharded {k}")
        want = padded_chunks(td, cfg_l, k)
        stats = {w: warm_stats(ms[w]) for w in ways}
        stats["whole"].update(profiled(ways["whole"], booked["whole"],
                                       stats["whole"]["warm_ms"]))
        a, p, o = outs["whole"]
        r = rec[k] = {
            "first_call": first, "padded_chunks": want,
            "k1a_launches_measured": stats["whole"]["launches"]["K1"][
                "mono"], "steady_state_captures": captures, **stats,
            "whole_over_host": (stats["whole"]["warm_ms"]
                                / stats["host"]["warm_ms"]),
            # acc, pot, flags
            "bit_equal_to_host": [bool(torch.equal(x, y))
                                  for x, y in zip((a, p, o), hosts[k])],
            "bit_equal_to_acc_pot_u": [bool(torch.equal(a, a1)),
                                       bool(torch.equal(p, p1))],
            "first_call_equal": _leaves_equal(out, outs["whole"]),
            "overflow": o.tolist()}
        if (not all(r["bit_equal_to_host"] + r["bit_equal_to_acc_pot_u"])
                or not r["first_call_equal"] or o.any() or o1.any()
                or captures
                or booked["whole"] != launched(booked["whole"],
                                               {"K1": {"mono": want}})):
            raise AssertionError(f"multi sharded whole {k}: {r}")
    return rec


def step_whole(state, cfg) -> dict:
    """Phase multi, the whole sharded step: sharded.leapfrog_step_sharded
    at LET_SHARDS shards (one CUDA graph: two builds, two sharded queries
    over the padded capacity chunks, the KDK arithmetic) against
    leapfrog_step_sharded_host and integrate.leapfrog_step (one device;
    its body run once eagerly, graph=False: its graph is timed in phase
    leapfrog, on config #2), from one state: the sharded whole step's first call
    (first_call), STEP_REPS warm steps of the two sharded twins in turns
    that capture nothing, the sharded whole step's K1a launches
    (bookkeeping) 2 x the padded capacity chunks. pos and vel are
    expected bit-equal across the three; where the sharded whole step
    parts from the single-device one, the record names where (the first
    build's query, or what follows it) and the step tolerances must hold.
    Raises on a flag. Returns the record."""
    from rakau_tpu_torch import build, integrate
    from rakau_tpu_torch.parallel import sharded
    mesh = sharded.default_mesh(LET_SHARDS)
    args = (state, MULTI_DT, cfg, THETA, MULTI_EPS)
    ways = {"sharded_whole": lambda: sharded.leapfrog_step_sharded(
                *args, 1.0, mesh),
            "sharded_host": lambda: sharded.leapfrog_step_sharded_host(
                *args, 1.0, mesh)}
    ways["sharded_host"]()              # its graphs, as a step finds them
    first = first_call(ways["sharded_whole"])[1]
    outs, ms, booked, captures = in_turns(ways, STEP_REPS, "multi step")
    outs["single_whole"] = integrate.leapfrog_step(*args, graph=False)
    stats = {w: warm_stats(ms[w]) for w in ways}
    td = build.build_tree(state.pos, state.mass, cfg)
    want = 2 * padded_chunks(td, cfg, LET_SHARDS)
    s, o = outs["sharded_whole"]
    rec = {"n": state.pos.shape[0], "shards": LET_SHARDS,
           "first_call": first, "k1a_launches_want": want,
           "k1a_launches_booked": booked["sharded_whole"]["K1"]["mono"],
           "steady_state_captures": captures, **stats,
           "sharded_whole_over_host": (stats["sharded_whole"]["warm_ms"]
                                       / stats["sharded_host"]["warm_ms"]),
           "overflow": [v[1].tolist() for v in outs.values()]}
    for w in ("single_whole", "sharded_host"):
        ref = outs[w][0]
        rec[f"bit_equal_to_{w}"] = [bool(torch.equal(s.pos, ref.pos)),
                                    bool(torch.equal(s.vel, ref.vel))]
        rec[f"max_abs_diff_{w}"] = [float((s.pos - ref.pos).abs().max()),
                                    float((s.vel - ref.vel).abs().max())]
    ref = outs["single_whole"][0]
    if not all(rec["bit_equal_to_single_whole"]):
        # where the sharded whole step parts from the single-device one
        q = [integrate.acc_pot(state.pos, state.mass, cfg, THETA, MULTI_EPS,
                               graph=False),
             sharded.acc_pot_sharded(state.pos, state.mass, cfg, THETA,
                                     MULTI_EPS, 1.0, mesh, graph=False)]
        rec["parts_at"] = ("the first build's query" if not torch.equal(
            q[0][0], q[1][0]) else "after the first build's query")
    pos_tol = STEP_POS_ATOL_REL * float(ref.pos.abs().max())
    vel_tol = STEP_VEL_ATOL_REL * float(ref.vel.abs().max())
    if (any(any(v) for v in rec["overflow"]) or captures
            or booked["sharded_whole"] != launched(
                booked["sharded_whole"], {"K1": {"mono": want}})
            or any(d[0] > pos_tol or d[1] > vel_tol for d in (
                rec["max_abs_diff_single_whole"],
                rec["max_abs_diff_sharded_host"]))):
        raise AssertionError(f"multi step whole: {rec}")
    return rec


def let_whole(pos, mass, cfg_q, caps: dict, mesh, oracle, dev) -> dict:
    """Phase multi, the whole LET: let.acc_pot_let (one CUDA graph a call:
    phase 0, the local builds, the domains, the export walk, the
    exchange, the local queries over each shard's tile capacity, the
    return route) on let_check's particles, mesh and caps, in both phase0
    modes, against acc_pot_let_host: the first call (first_call), LET_REPS
    warm calls each way in turns that capture nothing, and
    (distributed) a profiled replay whose K1a launches on the card must
    equal the bookkeeping's. Raises unless the sums, flags, export
    overflow and export counts are bit-equal to the host twin's and no
    flag is set. Returns the record with the whole call's force and
    potential RMS against the oracle (acc_o, pot_o, samp)."""
    from rakau_tpu_torch.parallel import let
    rec = {}
    for phase0 in ("distributed", "global"):
        kw = dict(phase0=phase0, with_stats=True, **caps)
        args = (pos, mass, cfg_q, THETA, MULTI_EPS, 1.0, mesh)
        ways = {"whole": lambda: let.acc_pot_let(*args, **kw),
                "host": lambda: let.acc_pot_let_host(*args, **kw)}
        ways["host"]()                  # its graphs, as a step finds them
        _, first = first_call(ways["whole"])
        outs, ms, booked, captures = in_turns(ways, LET_REPS,
                                              f"multi let {phase0}")
        stats = {w: warm_stats(ms[w]) for w in ways}
        if phase0 == "distributed":
            stats["whole"].update(profiled(ways["whole"], booked["whole"],
                                           stats["whole"]["warm_ms"]))
        w, h = outs["whole"], outs["host"]
        f_rms, p_rms = sampled_rms(w[0], w[1], *oracle, dev)
        r = rec[phase0] = {
            "first_call": first, "steady_state_captures": captures,
            **stats, "whole_over_host": (stats["whole"]["warm_ms"]
                                         / stats["host"]["warm_ms"]),
            "k1a_launches": {v: booked[v]["K1"]["mono"] for v in ways},
            "bit_equal_to_host": [bool(torch.equal(x, y))
                                  for x, y in zip(w, h)],
            "overflow": w[2].tolist(), "export_ovf": bool(w[3]),
            "force_rms": f_rms, "pot_rms": p_rms}
        if (not all(r["bit_equal_to_host"]) or w[2].any() or w[3]
                or captures):
            raise AssertionError(f"multi let whole {phase0}: {r}")
    return rec


def let_sized(pos, mass, cfg, eps, mesh, caps: dict, box_size=None,
              phase0: str = "distributed"):
    """acc_pot_let_host with the query's caps grown on overflow and the
    export caps raised while export_ovf is set (export_cap to the power of
    two above the largest count when a count exceeds it, else the walk's
    four caps doubled). Returns ((acc, pot, counts), seconds of the last
    (synced) run, launches of its K1 forms, caps, query config)."""
    from rakau_tpu_torch.config import grow_overflowed
    from rakau_tpu_torch.parallel import let
    caps = dict(caps)
    for _ in range(MULTI_TRIES):
        (out, counts), ms = synced_ms(lambda: counted(
            lambda: let.acc_pot_let_host(
                pos, mass, cfg, THETA, eps, 1.0, mesh, box_size=box_size,
                phase0=phase0, with_stats=True, **caps)))
        acc, pot, ovf, xo, cnt = out
        if ovf.any():
            cfg = grow_overflowed(cfg, ovf.tolist())
        elif xo and int(cnt.max()) > caps["export_cap"]:
            caps["export_cap"] = 1 << (int(cnt.max()) - 1).bit_length()
        elif xo:
            caps.update({k: 2 * v for k, v in caps.items()
                         if k != "export_cap"})
        else:
            return (acc, pot, cnt), ms / 1e3, counts["K1"], caps, cfg
    raise AssertionError(f"multi let: overflow {ovf.tolist()}, export "
                         f"overflow {bool(xo)} at caps {caps}")


def let_check(n: int, cfg_l, seed: int, dev) -> tuple:
    """The LET on n Plummer particles, LET_SHARDS shards, shared+"local"
    with the main phase's caps, theta THETA, eps MULTI_EPS, distributed
    phase 0 (caps sized by let_sized): against the float64 direct sum on
    256 sampled
    targets (force RMS below max(LET_FORCE_RATIO x the single-device
    query's, LET_FORCE_FLOOR), potential RMS < LET_POT_MAX); phase0
    "global" against it (RMS < LET_CROSS_MAX); the export matrix, the halo
    bytes and the seconds of each stage."""
    from rakau_tpu_torch import direct_acc_pot_np, integrate, particles
    from rakau_tpu_torch.parallel import let, sharded
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(n, generator=gen)
    ndim = pos.shape[1]
    mesh = sharded.default_mesh(LET_SHARDS)
    (acc, pot, cnt), let_s, k1, caps, cfg_q = let_sized(
        pos, mass, cfg_l, MULTI_EPS, mesh, LET_CAPS)
    (acc_g, _, ovf_g, xo_g, _) = let.acc_pot_let_host(
        pos, mass, cfg_q, THETA, MULTI_EPS, 1.0, mesh, phase0="global",
        with_stats=True, **caps)
    with let.stage_seconds() as stages:
        let.acc_pot_let_host(pos, mass, cfg_q, THETA, MULTI_EPS, 1.0, mesh,
                        **caps)
    # the whole LET with its local query run eagerly and from CUDA graphs
    # (the default): the first graphed run captures (the cache emptied
    # first, as let_sized's first run found it), the second replays
    local = {}
    for mode, graph in (("eager", False), ("graphed_capture", None),
                        ("graphed_replay", None), ("eager_again", False)):
        if mode == "graphed_capture":
            from rakau_tpu_torch import engine
            engine.clear_graphs()
        with engine_graph(graph), let.stage_seconds() as st:
            _, ms = synced_ms(lambda: let.acc_pot_let_host(
                pos, mass, cfg_q, THETA, MULTI_EPS, 1.0, mesh, **caps))
        local[mode] = {"let_s": ms / 1e3, "stage_s": dict(st)}
    # a second particle set of the same count, as a step hands the LET:
    # the shards' fixed buffers keep every shape, so it replays (the
    # graphs' tally records no capture)
    gen2 = torch.Generator(device=dev).manual_seed(seed + 1)
    pos2, mass2 = particles.plummer(n, generator=gen2)
    (_, booked), ms = synced_ms(lambda: counted(
        lambda: let.acc_pot_let_host(pos2, mass2, cfg_q, THETA, MULTI_EPS,
                                     1.0, mesh, **caps)))
    from rakau_tpu_torch import engine
    local["graphed_new_particles"] = {
        "let_s": ms / 1e3, "k1a_launches": booked["K1"]["mono"],
        "captured": [dict(c) for c in engine._GRAPHS.captured]}

    def single(c):
        out, ms = synced_ms(lambda: integrate.acc_pot_host(
            pos, mass, c, THETA, MULTI_EPS))
        return (out[:2], ms), out[2]

    ((acc_1, pot_1), single_s), _ = clear_of_overflow(
        single, cfg_q, "LET single-device query")
    samp = np.sort(np.random.default_rng(seed).choice(n, 256, replace=False))
    acc_o, pot_o = direct_acc_pot_np(pos.double().cpu().numpy(),
                                     mass.double().cpu().numpy(),
                                     eps=MULTI_EPS, targets=samp)
    f_let, p_let = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
    f_one, p_one = sampled_rms(acc_1, pot_1, acc_o, pot_o, samp, dev)
    cross = rel_rms(acc, acc_g)
    item = pos.element_size() * (ndim + 1)
    rec = dict(
        n=n, shards=LET_SHARDS, devices=[str(d) for d in mesh.devices],
        theta=THETA, eps=MULTI_EPS, phase0="distributed", caps_used=caps,
        query_caps={f: getattr(cfg_q, f) for f in
                    ("m2p_cap", "p2p_leaf_cap", "p2p_src_cap",
                     "frontier_cap")},
        export_counts=cnt.tolist(), halo_bytes=int(cnt.sum()) * item,
        halo_slot_bytes=LET_SHARDS * (LET_SHARDS - 1) * caps["export_cap"]
        * item, let_query_s=let_s, single_query_s=single_s / 1e3,
        stage_s=stages, local_query_graph_ab=local,
        k1_launches={f: v for f, v in k1.items() if v},
        force_rms=f_let, pot_rms=p_let, single_force_rms=f_one,
        single_pot_rms=p_one, global_vs_distributed_rms=cross)
    rec["whole"] = let_whole(pos, mass, cfg_q, caps, mesh,
                             (acc_o, pot_o, samp), dev)
    if (ovf_g.any() or xo_g
            or not f_let < max(LET_FORCE_RATIO * f_one, LET_FORCE_FLOOR)
            or not p_let < LET_POT_MAX or not cross < LET_CROSS_MAX):
        raise AssertionError(f"multi let: {rec}, global flags "
                             f"{ovf_g.tolist()} {bool(xo_g)}")
    return rec, (pos, mass, cfg_q, caps)


def let_accuracy_engine(seed: int, dev) -> dict:
    """The accuracy engine through the LET (__graft_entry__.py:128-156):
    lmac + "m2p" + quadrupole, F1_N Plummer particles, LET_SHARDS shards,
    eps LET_ACC_EPS, box LET_ACC_BOX, against the same engine on one
    device: max |acc_let - acc_1| / max |acc_1| <= LET_ACC_DEV_MAX."""
    from rakau_tpu_torch import integrate, particles
    from rakau_tpu_torch.config import TreeConfig
    from rakau_tpu_torch.parallel import sharded
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(F1_N, generator=gen)

    def single(c):
        out = integrate.acc_pot_host(pos, mass, c, THETA, LET_ACC_EPS,
                                     box_size=LET_ACC_BOX)
        return out[:2], out[2]

    (acc_1, _), cfg = clear_of_overflow(single, TreeConfig(**LET_ACC_KW),
                                        "accuracy engine")
    mesh = sharded.default_mesh(LET_SHARDS)
    (acc, _, cnt), let_s, k1, caps, _ = let_sized(
        pos, mass, cfg, LET_ACC_EPS, mesh, LET_CAPS, box_size=LET_ACC_BOX)
    dev_max = float((acc - acc_1).norm(dim=1).max()
                    / acc_1.norm(dim=1).max())
    rec = dict(n=F1_N, shards=LET_SHARDS, config="lmac+m2p+quadrupole",
               eps=LET_ACC_EPS, box=LET_ACC_BOX, caps_used=caps,
               export_counts=cnt.tolist(), let_query_s=let_s,
               k1_launches={f: v for f, v in k1.items() if v},
               max_rel_dev=dev_max)
    if not dev_max <= LET_ACC_DEV_MAX:
        raise AssertionError(f"multi let accuracy engine: {rec}")
    return rec


def multi(pos, mass, cfg, seed: int, dev, let_n: int) -> tuple:
    """Phase multi: the F2 repair (f2_check), the tile-sharded query and
    step on pos, mass (SMALL_N particles) with the main caps (cfg) through
    the _host twins (sharded_check) and the whole twins (sharded_whole,
    step_whole), the LET on let_n Plummer particles through both twins
    (let_check, let_whole) and on the accuracy engine
    (let_accuracy_engine); the seconds of each part. Every shard of a
    mesh sits on cuda:(r % card count): with one card all shards share
    it, and no copy between cards is made (phase multicard makes them).
    Returns the record and let_check's particles, query configuration and
    caps (for phase multicard)."""
    from rakau_tpu_torch import engine
    t0 = time.perf_counter()
    rec = dict(cards=torch.cuda.device_count(), n=pos.shape[0], part_s={})

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec["part_s"][name] = time.perf_counter() - t
        return out

    rec["f2"] = part("f2", lambda: f2_check(seed, dev))
    rec["sharded"], cfg_l, (td, cfg_g, hosts, state, cfg_s) = part(
        "sharded", lambda: sharded_check(pos, mass, cfg, dev))
    rec["sharded_whole"] = part("sharded_whole",
                                lambda: sharded_whole(td, cfg_g, hosts))
    rec["step_whole"] = part("step_whole", lambda: step_whole(state, cfg_s))
    del td, hosts, state
    engine.clear_graphs()
    rec["let"], let_set = part("let", lambda: let_check(let_n, cfg_l,
                                                        seed + 1, dev))
    torch.cuda.empty_cache()
    rec["let_accuracy_engine"] = part(
        "let_accuracy_engine", lambda: let_accuracy_engine(seed + 2, dev))
    if rec["cards"] == 1:
        rec["note"] = ("one card: every shard ran on cuda:0; copies between "
                       "cards were not exercised here (phase multicard)")
    rec["seconds"] = time.perf_counter() - t0
    emit("multi", **rec)
    return rec, let_set


# ------------------------------------------------------- phase multicard
# the staged pipelines on one card: the sharded query's shards, the LET's
# particles; warm calls of each way (in turns) there and across cards
MC_SHARDS, MC_LET_N, MC_REPS = LET_SHARDS, LET_N, 3
# across cards: the LET's particles (the accuracy engine's are F1_N)
MC_CROSS_LET_N = 262144


def all_synced_ms(fn):
    """(fn(), wall ms) with every card synchronised before and after."""
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = fn()
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    return out, (time.perf_counter() - t0) * 1e3


def card_profile(fn) -> tuple:
    """fn() under torch.profiler (CUDA activity only): the K1a records of
    each card (kineto's device index), held to the bookkeeping of the same
    call (counted; the profiler can drop a record, so the call is
    profiled again, at most PROFILE_TRIES times, until the cards' sum
    shows it), each card's busy ms (the union of its device records) and
    busy share of the call's wall ms (every card synchronised). Returns
    (fn(), the record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_SHIFT * (tries - 1)):
                torch.cuda._sleep(1)
            (out, ms), booked = counted(lambda: all_synced_ms(fn))
        k1a, by_card = {}, {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            d = e.device_index()
            by_card.setdefault(d, []).append(e)
            name = e.name()
            if ("shared_fused_kernel" in name
                    and kernel_form(name) == ("K1", "mono")):
                k1a[d] = k1a.get(d, 0) + 1
        want = booked["K1"]["mono"]
        if sum(k1a.values()) == want:
            busy = {d: device_busy(ev)[1] for d, ev in sorted(by_card.items())}
            return out, {"k1a_launches_by_card": dict(sorted(k1a.items())),
                         "k1a_launches_booked": want, "profiled_ms": ms,
                         "busy_ms_by_card": busy,
                         "busy_share_by_card": {d: b / ms
                                                for d, b in busy.items()},
                         "profile_runs": tries}
        seen.append(k1a)
    raise AssertionError(f"K1a on the cards' profiles {seen}, by the "
                         f"bookkeeping {want}")


def graphs_on_their_cards() -> dict:
    """The graph cache's graphs by device, each one's static inputs and
    outputs held to lie on its key's device (a graph captured on one card
    never serves another)."""
    from rakau_tpu_torch import engine
    by_dev = {}
    for k, g in engine._GRAPHS._graphs.items():
        dev = k[2][0][2]
        if any(t.device != dev for t in g.inputs + g.outputs):
            raise AssertionError(f"graph {k[0].__name__} keyed on {dev} "
                                 "holds tensors of another device")
        by_dev[str(dev)] = by_dev.get(str(dev), 0) + 1
    return by_dev


def mc_case(ways: dict, flags, want_k1a=None) -> dict:
    """One comparison of phase multicard. ways: "one" (the call on a
    one-card mesh, the reference), "staged" (the same on the staged
    pipeline, the cross-card way or, on one card, the internal staged
    function) and optionally "host" and "eager" (the _host twin and
    graph=False on the staged way's mesh). The graphs emptied, the first
    call of "one" then of "staged" (seconds, captures), MC_REPS warm calls
    of both in turns (every card synchronised; none may capture), one
    profiled call of "staged" (card_profile: K1a a card, summing to
    want_k1a where given; busy shares; the bytes the collectives copied
    between cards), then "host" and "eager" once each. Raises unless
    every way's outputs are bit-equal to "one"'s and flags(out) is
    clear. Returns the record."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.parallel import mesh as pm
    engine.clear_graphs()
    outs, rec = {}, {"first_call_s": {}, "first_call_captures": {}}
    for w in ("one", "staged"):
        engine._GRAPHS.reset_tally()
        outs[w], ms = all_synced_ms(ways[w])
        rec["first_call_s"][w] = ms / 1e3
        rec["first_call_captures"][w] = engine._GRAPHS.captures
    warm, captures = {"one": [], "staged": []}, 0
    for i in range(MC_REPS):
        for w in (("one", "staged") if i % 2 else ("staged", "one")):
            engine._GRAPHS.reset_tally()
            outs[w], ms = all_synced_ms(ways[w])
            warm[w].append(ms)
            captures += engine._GRAPHS.captures
    stats = {w: warm_stats(v) for w, v in warm.items()}
    pm.reset_copied()
    _, prof = card_profile(ways["staged"])
    rec.update(stats=stats, staged_over_one=(stats["staged"]["warm_ms"]
                                             / stats["one"]["warm_ms"]),
               steady_state_captures=captures, profile=prof,
               # the profiled call's copies (each run copies the same)
               copied_bytes={f"{a}->{b}": v // prof["profile_runs"]
                             for (a, b), v in sorted(pm.copied.items())},
               graphs_by_device=graphs_on_their_cards())
    for w in ("host", "eager"):
        if w in ways:
            outs[w], ms = all_synced_ms(ways[w])
            rec[f"{w}_s"] = ms / 1e3
    rec["bit_equal_to_one"] = {w: _leaves_equal(outs[w], outs["one"])
                               for w in outs if w != "one"}
    rec["flags_clear"] = not any(bool(f.any()) for f in flags(outs["one"]))
    if want_k1a is not None:
        rec["k1a_want"] = want_k1a
    if (not all(rec["bit_equal_to_one"].values()) or not rec["flags_clear"]
            or captures or (want_k1a is not None
                            and prof["k1a_launches_booked"] != want_k1a)):
        raise AssertionError(f"multicard: {rec}")
    return rec


def local_config(td, cfg):
    """cfg with farfield "local" and its caps grown until the main tree's
    single-device query clears them (sharded_check's start), then back to
    "grid": the sharded query's configuration (it falls back to
    "local")."""
    from rakau_tpu_torch import engine

    def single(c):
        out = engine.acc_pot_u_host(td, c, THETA, 0.0)
        return None, out[2]

    return clear_of_overflow(single, cfg.with_(farfield="local"),
                             "single-device query")[1].with_(farfield="grid")


def mc_let_setup(n: int, cfg, seed: int, mesh, eps=MULTI_EPS, box=None):
    """n Plummer particles from seed on cuda:0 and the LET's caps for
    `mesh` (let_sized, the _host twin): (pos, mass, query config, caps)."""
    from rakau_tpu_torch import particles
    gen = torch.Generator(device="cuda:0").manual_seed(seed)
    pos, mass = particles.plummer(n, generator=gen)
    _, _, _, caps, cfg_q = let_sized(pos, mass, cfg, eps, mesh, LET_CAPS,
                                     box_size=box)
    return pos, mass, cfg_q, caps


def let_flags(out):
    return out[2], out[3]


def mc_let_ways(pos, mass, cfg_q, caps, mesh, one, eps=MULTI_EPS, box=None,
                phase0="distributed", staged_fn=False) -> dict:
    """The LET's ways for mc_case: the whole twin on the one-card mesh
    `one` and on `mesh` (staged_fn: let._let with staged=True, the
    internal function, instead of the public call), and across cards its
    _host twin and graph=False."""
    from rakau_tpu_torch import build, engine
    from rakau_tpu_torch.parallel import let
    kw = dict(box_size=box, phase0=phase0, with_stats=True, **caps)
    args = (pos, mass, cfg_q, THETA, eps, 1.0)
    ways = {"one": lambda: let.acc_pot_let(*args, one, **kw)}
    if staged_fn:
        cap_t = tuple(caps[k] for k in ("export_cap", "export_node_cap",
                                        "export_part_cap", "export_leaf_cap",
                                        "export_frontier_cap"))
        # theta, eps and G as the whole twin hands them to _let
        inner = args[:3] + engine.scalars(pos, *args[3:])
        ways["staged"] = lambda: let._let(
            *inner, mesh, box, cap_t, phase0, 2.0, 128, build.build_tree,
            engine._query_impl, staged=True)
        return ways
    ways["staged"] = lambda: let.acc_pot_let(*args, mesh, **kw)
    ways["host"] = lambda: let.acc_pot_let_host(*args, mesh, **kw)
    ways["eager"] = lambda: let.acc_pot_let(*args, mesh, graph=False, **kw)
    return ways


def multicard_one(td, cfg_g, let_set, seed: int) -> dict:
    """Phase multicard on one card: the staged pipelines (the functions
    the public whole twins call on a mesh over several cards) replaying
    their per-card graphs on cuda:0, against the one-graph whole twins on
    the same one-card mesh: the sharded query at MC_SHARDS shards on td
    (cfg_g, as sharded_whole), K1a = the padded capacity
    chunks; the LET in both phase0 modes on let_set (phase multi's
    let_check particles, query configuration and caps at MC_SHARDS
    shards), or where None on MC_LET_N particles (at most the main
    tree's) sized here, shared+"local" with the main caps."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.parallel import sharded
    from rakau_tpu_torch.parallel.mesh import Mesh
    dev0 = torch.device("cuda", 0)
    one = Mesh((dev0,) * MC_SHARDS)
    args = (td, cfg_g, THETA, 0.0, 1.0, one)
    # theta, eps and G as acc_pot_u_sharded hands them to _query_impl
    inner = (td, cfg_g) + engine.scalars(td.pos, THETA, 0.0, 1.0) + (one,)
    rec = {"shards": MC_SHARDS, "query": mc_case(
        {"one": lambda: sharded.acc_pot_u_sharded(*args),
         "staged": lambda: sharded._query_impl(*inner, staged=True)},
        lambda out: out[2:3],
        padded_chunks(td, cfg_g.with_(farfield="local"), MC_SHARDS))}
    pos, mass, cfg_q, caps = let_set or mc_let_setup(
        min(MC_LET_N, td.pos.shape[0]), cfg_g.with_(farfield="local"), seed,
        one)
    rec["let"] = {"n": pos.shape[0], "caps": caps}
    for phase0 in ("distributed", "global"):
        rec["let"][phase0] = mc_case(
            mc_let_ways(pos, mass, cfg_q, caps, one, one, phase0=phase0,
                        staged_fn=True), let_flags)
    return rec


def multicard_cross(pos, mass, td, cfg_g, n: int, seed: int) -> dict:
    """Phase multicard across the cards: on default_mesh() (a shard a
    card) and default_mesh(2 x cards), each whole twin against the same
    call on a one-card mesh of as many shards (mc_case), with its _host
    twin and graph=False across the cards: the sharded query on the main
    tree, the sharded step and acc_pot_sharded on the main particles, the
    LET at MC_CROSS_LET_N (at most n) in both phase0 modes and the
    accuracy engine's LET at F1_N; then, on default_mesh() only, the
    query on cards x n particles (the weak-scaling shape). Each case is
    printed as it ends (phase multicard_case). A case that fails is
    recorded under
    "failures" and the others still run (multicard raises after printing
    the record)."""
    from rakau_tpu_torch import build, engine, integrate, particles
    from rakau_tpu_torch.config import TreeConfig
    from rakau_tpu_torch.parallel import mesh as pm
    from rakau_tpu_torch.parallel import sharded
    cards = torch.cuda.device_count()
    dev0 = torch.device("cuda", 0)
    rec = {"peer_access": {
        f"cuda:{a}->cuda:{b}": torch.cuda.can_device_access_peer(a, b)
        for a in range(cards) for b in range(cards) if a != b},
           "meshes": {}, "failures": []}

    def case(where: str, fn):
        engine.clear_graphs()
        t = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 (recorded, raised after)
            rec["failures"].append(f"{where}: {type(e).__name__}: "
                                   f"{str(e)[:1500]}")
            out = {"error": rec["failures"][-1]}
        # each case on a line of its own as it ends
        emit("multicard_case", case=where, seconds=time.perf_counter() - t,
             **out)
        return out

    gen = torch.Generator(device=dev0).manual_seed(seed)
    pos_w, mass_w = particles.plummer(cards * n, generator=gen)
    td_w = build.build_tree(pos_w, mass_w, cfg_g)
    if bool(td_w.overflow):
        raise AssertionError("multicard: the weak-scaling build overflowed")
    cfg_w = local_config(td_w, cfg_g)
    rec["weak"] = {"n": cards * n, "caps": {
        f: getattr(cfg_w, f) for f in ("m2p_cap", "p2p_leaf_cap",
                                       "p2p_src_cap", "frontier_cap")}}
    state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)
    cfg_l = cfg_g.with_(farfield="local")
    # the trees acc_pot_sharded and the step build ("local" clips no tile)
    td_l = build.build_tree(pos, mass, cfg_l)

    def step1(c):
        out = integrate.leapfrog_step_host(state, MULTI_DT, c, THETA,
                                           MULTI_EPS)
        return None, out[1]

    cfg_s = clear_of_overflow(step1, cfg_l, "leapfrog_step_host")[1]

    def single(c):
        out = integrate.acc_pot_host(ap, am, c, THETA, LET_ACC_EPS,
                                     box_size=LET_ACC_BOX)
        return None, out[2]

    gen = torch.Generator(device=dev0).manual_seed(seed + 2)
    ap, am = particles.plummer(F1_N, generator=gen)
    acfg = clear_of_overflow(single, TreeConfig(**LET_ACC_KW),
                             "accuracy engine")[1]
    gen = torch.Generator(device=dev0).manual_seed(seed + 1)
    lp, lm = particles.plummer(min(MC_CROSS_LET_N, n), generator=gen)

    def query_ways(t, c, mesh, one):
        args = (t, c, THETA, 0.0, 1.0)
        return {"one": lambda: sharded.acc_pot_u_sharded(*args, one),
                "staged": lambda: sharded.acc_pot_u_sharded(*args, mesh),
                "host": lambda: sharded.acc_pot_u_sharded_host(*args, mesh),
                "eager": lambda: sharded.acc_pot_u_sharded(*args, mesh,
                                                           graph=False)}

    def twin_ways(name, first, c, mesh, one):
        whole = getattr(sharded, name)
        host = getattr(sharded, name + "_host")
        args = first + (c, THETA, MULTI_EPS, 1.0)
        return {"one": lambda: whole(*args, one),
                "staged": lambda: whole(*args, mesh),
                "host": lambda: host(*args, mesh),
                "eager": lambda: whole(*args, mesh, graph=False)}

    def let_case(p, m_, c, eps, box, phase0s, mesh, one):
        _, _, _, caps, cfg_q = let_sized(p, m_, c, eps, mesh, LET_CAPS,
                                         box_size=box)
        out = {"n": p.shape[0], "caps": caps}
        for phase0 in phase0s:
            out[phase0] = mc_case(mc_let_ways(p, m_, cfg_q, caps, mesh, one,
                                              eps=eps, box=box,
                                              phase0=phase0), let_flags)
        return out

    for k in (cards, 2 * cards):
        mesh = sharded.default_mesh(k)
        one = pm.Mesh((dev0,) * k)
        m = rec["meshes"][k] = {"devices": [str(d) for d in mesh.devices]}
        m["query"] = case(f"query {k}", lambda: mc_case(
            query_ways(td, cfg_g, mesh, one), lambda out: out[2:3],
            padded_chunks(td, cfg_l, k)))
        m["step"] = case(f"step {k}", lambda: mc_case(
            twin_ways("leapfrog_step_sharded", (state, MULTI_DT), cfg_s,
                      mesh, one), lambda out: out[1:2],
            2 * padded_chunks(td_l, cfg_s, k)))
        m["acc_pot_sharded"] = case(f"acc_pot_sharded {k}", lambda: mc_case(
            twin_ways("acc_pot_sharded", (pos, mass), cfg_l, mesh, one),
            lambda out: out[2:3], padded_chunks(td_l, cfg_l, k)))
        m["let"] = case(f"let {k}", lambda: let_case(
            lp, lm, cfg_l, MULTI_EPS, None, ("distributed", "global"), mesh,
            one))
        m["let_accuracy_engine"] = case(
            f"let_accuracy_engine {k}", lambda: let_case(
                ap, am, acfg, LET_ACC_EPS, LET_ACC_BOX, ("distributed",),
                mesh, one))
    # the weak-scaling query, a shard a card (the costliest case, last)
    mesh = sharded.default_mesh(cards)
    rec["meshes"][cards]["query_weak"] = case(
        f"query_weak {cards}", lambda: mc_case(
            query_ways(td_w, cfg_w, mesh, pm.Mesh((dev0,) * cards)),
            lambda out: out[2:3], padded_chunks(td_w, cfg_l, cards)))
    engine.clear_graphs()
    torch.cuda.empty_cache()
    return rec


def local_tree(pos, mass, cfg) -> tuple:
    """The tree of pos, mass under local_config of cfg, and that
    configuration: the sharded query's (phase multicard)."""
    from rakau_tpu_torch import build
    cfg_g = local_config(build.build_tree(pos, mass, cfg), cfg)
    return build.build_tree(pos, mass, cfg_g), cfg_g


def multicard(pos, mass, cfg, small, let_set, seed: int, n: int) -> dict:
    """Phase multicard: multicard_one on `small` (SMALL_N particles, the
    main caps cfg) on every run; with more than one card,
    multicard_cross on the main particles pos, mass. The sharded query's
    configuration is local_config of cfg on each tree; let_set: phase
    multi's LET set (let_check), or None (then a LET set sized here)."""
    from rakau_tpu_torch import engine
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    rec = {"cards": cards, "cards_nvidia_smi": card_lines()}
    failures = []
    t = time.perf_counter()
    td, cfg_g = local_tree(*small, cfg)
    rec["one_card"] = dict(multicard_one(td, cfg_g, let_set, seed),
                           n=td.pos.shape[0])
    rec["one_card_s"] = time.perf_counter() - t
    del td
    engine.clear_graphs()
    torch.cuda.empty_cache()
    if cards > 1:
        t = time.perf_counter()
        td, cfg_g = local_tree(pos, mass, cfg)
        rec["cross"] = multicard_cross(pos, mass, td, cfg_g, n, seed + 3)
        rec["cross_s"] = time.perf_counter() - t
        failures = rec["cross"]["failures"]
        del td
    else:
        rec["note"] = ("one card: the staged pipelines ran on cuda:0 only; "
                       "the cross-card part did not run")
    engine.clear_graphs()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    emit("multicard", **rec)
    if failures:
        raise AssertionError(f"multicard across the cards: {failures}")
    return rec


def main_path(n: int, seed: int, pos, mass, small, dev) -> dict:
    """Phase group "main": phases main through f1 on the main particles
    (engine.acc_pot_u's check on `small`'s). Returns what the kernels
    line and phases multi and multicard take."""
    from rakau_tpu_torch import engine, octree
    from rakau_tpu_torch.kernels import pool, shared
    # ---- main path -----------------------------------------------------
    torch.cuda.synchronize()
    shared.reset_launches()
    t0 = time.perf_counter()
    tree = octree(coords=pos, masses=mass, **TREE_KW)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3

    def query():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = tree.accs_pots_o(THETA)
        stop.record()
        stop.synchronize()
        return out, start.elapsed_time(stop)

    _, cold_ms = query()
    # the wrappers' own count over the build and the cold query, which
    # runs each graph's warm-up eagerly and captures it
    cold_launches = shared.launches["mono"]
    warm, booked = [], []
    for _ in range(WARM_REPS):
        ((acc, pot), ms), counts = counted(query)
        booked.append(counts)
        warm.append(ms)
    warm_ms = statistics.median(warm)
    td, cfg = tree.tree_data, tree.config
    chunks = engine.live_chunks(td, cfg)
    evaluated = query_chunks(td, cfg)
    # one more warm query under the profiler: its K1a records are the
    # launches the main path's query makes on the card
    prof = device_profile(tree, "shared_fused_", "k1a_device_ms")
    want = launched(prof["launches"], {"K1": {"mono": evaluated}})
    launches = prof["launches"]["K1"]["mono"]
    emit("main", n=n, theta=THETA, build_ms=build_ms,
         cold_query_ms=cold_ms, warm_query_ms=warm_ms, warm_query_ms_all=warm,
         warm_spread=(max(warm) - min(warm)) / warm_ms,
         n_nodes=tree.n_nodes, n_tiles=int(td.n_tiles), chunks=chunks,
         chunk_evaluations=evaluated, launches=launches,
         booked_launches_per_warm_query=[c["K1"]["mono"] for c in booked],
         cold_launches=cold_launches,
         caps={f: getattr(cfg, f) for f in
               ("m2p_cap", "p2p_leaf_cap", "p2p_src_cap", "frontier_cap")},
         evals_per_s=n / (warm_ms / 1e3))
    if prof["launches"] != want or chunks <= 0 or cold_launches <= 0:
        raise AssertionError(
            f"main path: launches on the card's profile "
            f"{nonzero(prof['launches'])}, want {evaluated} K1a (the chunk "
            f"evaluations) and nothing else; {cold_launches} K1a by the "
            f"wrappers in the build and cold query")
    if any(c != want for c in booked):
        raise AssertionError(f"main path: booked launches {booked} differ "
                             f"from the profile's {nonzero(want)}")
    if acc.shape != (n, 3) or pot.shape != (n,):
        raise AssertionError(f"bad shapes {acc.shape} {pot.shape}")
    if not (torch.isfinite(acc).all() and torch.isfinite(pot).all()):
        raise AssertionError("non-finite accelerations or potentials")

    scalar_sweep(tree, acc)
    # ---- where a warm query's time goes ---------------------------------
    emit("layers", warm_query_ms=warm_ms, **layer_ms(tree))
    emit("profile", **profile_record(prof, warm_ms))
    # the graphed query against the eager one, and engine.acc_pot_u whole,
    # on `small` (their point, equal sums and launches, holds at any N)
    stree = octree(coords=small[0], masses=small[1], **TREE_KW)
    s_acc, s_pot = stree.accs_pots_o(THETA)     # its caps grown
    graphs_rec = {"shared+grid": graph_ab(
        stree, "shared+grid", {"K1": {"mono": query_chunks(
            stree.tree_data, stree.config)}}, "shared_fused_",
        "k1a_device_ms")}
    graphs_rec["shared+grid"]["n"] = int(small[0].shape[0])
    graphs_rec["acc_pot_u"] = acc_pot_u_check(stree)
    # the build's graph on the main tree, a steady-state Tree rebuild and
    # the graft entry's whole acc_pot (config #2's step, energy and build
    # follow in phase leapfrog)
    whole_rec = {"build main": build_ab(pos, mass, cfg, tree.box_size,
                                        "main (shared+grid)"),
                 "Tree rebuild": rebuild_captures(tree, pos),
                 "graft entry": graft_entry(seed + 8, dev)}

    # ---- kernel vs plain at the main path's chunk shapes ----------------
    worst, k_ms, p_ms, b_ms, per_mode = 0.0, [], [], [], {}
    for ch in range(min(2, chunks)):
        inputs = engine.kernel_inputs(td, cfg, THETA, 0.0, ch)[:6]
        for mode in ("both", "acc", "pot"):
            got = shared.eval_shared_fused(
                *inputs, scal(0.0, 1.0, inputs[0]), mode=mode)
            want = shared.eval_shared_plain(
                *inputs, scal(0.0, 1.0, inputs[0]), mode=mode)
            err = compare(got, want)
            worst = max(worst, err)
            km = cuda_ms(lambda: shared.eval_shared_fused(
                *inputs, scal(0.0, 1.0, inputs[0]), mode=mode), 10)
            pm = cuda_ms(lambda: shared.eval_shared_plain(
                *inputs, scal(0.0, 1.0, inputs[0]), mode=mode), 3)
            per_mode.setdefault(mode, []).append(
                {"chunk": ch, "ms": km, "plain_ms": pm, "max_abs_err": err})
            if mode == "both":
                k_ms.append(km)
                p_ms.append(pm)
        C, T, _ = inputs[0].shape
        b, b_by = bound(inputs, n)
        b_ms.append((b, b_by))
        emit("kernel", form="mono", chunk=ch, C=C, T=T,
             S=int(inputs[2].shape[0]), **k1_shape(inputs),
             modes={m: v[-1] for m, v in per_mode.items()},
             bound_ms=b, bound_by=b_by,
             pct_of_bound=100 * b / per_mode["both"][-1]["ms"])

    # ---- accuracy against the float64 oracle ----------------------------
    samp = np.sort(np.random.default_rng(seed + 1).choice(
        n, 256, replace=False))
    acc_o, pot_o, o_check = sampled_oracle(pos, mass, samp)
    a = acc[torch.as_tensor(samp, device=dev)].double().cpu().numpy()
    f_rel = np.linalg.norm(a - acc_o, axis=1) / np.linalg.norm(acc_o, axis=1)
    f_rms, p_rms = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
    emit("accuracy", samples=256, force_rms=f_rms, pot_rms=p_rms,
         force_max=float(f_rel.max()), oracle_check=o_check)
    if not f_rms < FORCE_RMS_MAX or not p_rms < POT_RMS_MAX:
        raise AssertionError(f"accuracy: force rms {f_rms:.3e}, "
                             f"pot rms {p_rms:.3e}")
    # ---- the row's other evaluators: K6 and K5 -------------------------
    # whole queries on `small` (their point: each launches its own kernel
    # once a chunk and gives K1a's accuracy within 1 %, at any N); their
    # kernel phase below keeps the main query's chunks
    oracle = (acc_o, pot_o, samp)
    s_samp = np.sort(np.random.default_rng(seed + 12).choice(
        small[0].shape[0], 256, replace=False))
    s_oracle = card_oracle(small[0], small[1], s_samp) + (s_samp,)
    vrec, _ = variant_queries(
        stree, s_oracle, sampled_rms(s_acc, s_pot, *s_oracle, dev), "mma",
        dev)
    del stree, s_acc, s_pot
    emit("variants", config="shared+grid", n=int(small[0].shape[0]),
         **vrec)
    # the kernels line's K6 and K5 rows: their launches and their times on
    # the main query's tree
    v_launches = variant_launches(tree, "shared+grid")
    v_forms = variant_kernels(tree, n, "shared+grid")
    density(tree, "shared+grid")
    del tree, td, acc, pot
    torch.cuda.empty_cache()

    # ---- grid2: the conv-M2L far field on the shared traversal ----------
    g2tree, g2qtree, c_launches, g2 = grid2_shared(pos, mass, oracle,
                                                   (f_rms, p_rms), dev)
    emit("grid2_layers", **grid2_layer_ms(g2tree, g2["warm_query_ms"]))
    grid2_tf32(g2tree, dev)
    c_forms = cell_kernels(g2tree, g2qtree, n)
    del g2tree, g2qtree
    torch.cuda.empty_cache()

    # ---- the lmac engine: no walk, one predicate panel a chunk -----------
    lmac_cpu_cuda(seed + 3, dev)
    lmac_cfg, lv_forms, lv_launches, lmac_rec = lmac_main(pos, mass, oracle,
                                                          dev)
    graphs_rec["lmac+grid2"] = lmac_rec["graphs"]
    torch.cuda.empty_cache()
    lmac_gate(seed + 4, dev)
    kernel_roofs(cfg, lmac_cfg)
    torch.cuda.empty_cache()

    # ---- the gwalk engine: one walk, one pool, one K2 launch -------------
    gtree, g_launches, grec = gwalk_main(pos, mass, oracle, (f_rms, p_rms),
                                         dev)
    graphs_rec["gwalk+grid"] = grec["graphs"]
    k2 = pool_kernel_phase(gtree, ("mono",), "gwalk+grid")
    del gtree
    qtree, q_launches = gwalk_quad(pos, mass, oracle, dev)
    k2.update({f: v for f, v in pool_kernel_phase(
        qtree, pool.FORMS, "gwalk+m2p quadrupole compensated").items()
        if f != "mono"})
    del qtree
    torch.cuda.empty_cache()
    gwalk_grid2(pos, mass, oracle, (g2["force_rms"], g2["pot_rms"]), dev)
    torch.cuda.empty_cache()

    # ---- the lists path: per-tile lists and K3 (K4 beside it) -----------
    with diag_modes():
        t_launches, t_forms, trec = lists_main(pos, mass, oracle,
                                               (f_rms, p_rms), dev, small)
        graphs_rec["lists"] = trec["graphs"]
        torch.cuda.empty_cache()
        lists_quad(seed + 5, dev)
    torch.cuda.empty_cache()

    # ---- F1: 2-D and float64 trees on the card --------------------------
    _, f64_launches, f64_forms = f1(seed + 6, dev)
    torch.cuda.empty_cache()

    return dict(
        cfg=cfg, launches=launches, worst=worst, k_ms=k_ms, p_ms=p_ms,
        b_ms=b_ms, graphs_rec=graphs_rec, whole_rec=whole_rec,
        c_launches=c_launches, c_forms=c_forms, v_forms=v_forms,
        v_launches=v_launches, lv_forms=lv_forms, lv_launches=lv_launches,
        g_launches=g_launches, q_launches=q_launches, k2=k2,
        t_launches=t_launches, t_forms=t_forms, f64_launches=f64_launches,
        f64_forms=f64_forms)


# ------------------------------------------------------------ phase scale
# The reference's own sizes on one card: bench.py's headline of 8,000,000
# Plummer particles (bench.py:38-39) through the shared and the gwalk
# engine, and BASELINE config #2 at 1 << 23 particles
# (benchmarks/configs.py:90), two of its steps
SCALE_N, SCALE_LF_N, SCALE_LF_STEPS = 8_000_000, 1 << 23, 2
# the float64 direct sum on the card: targets a pass ([c, N, 3] float64
# panels, 1.6 GB at 8M), and its agreement with direct_acc_pot_np on the
# first ORACLE_CHECK sampled targets (relative, per target)
ORACLE_CHUNK, ORACLE_CHECK, ORACLE_RTOL = 8, 8, 1e-12
# K2's plain version at 8M runs on this many tiles about the first window
# boundary of the pool (see scale_gwalk)
SCALE_POOL_TILES = PLAIN_TILES
# config #2's energy query at 1 << 23 starts its cap sizing from the caps
# a run of this group measured there (on an H100): from LF_KW's it took
# three doublings, each a query at 8M and a capture (as bench.py starts
# from the 8M run's fitted caps, bench.py:61-64); it still grows any cap
# that overflows
SCALE_E_CAPS = dict(m2p_cap=98304, p2p_leaf_cap=16384, p2p_src_cap=177152,
                    frontier_cap=4864)


def card_oracle(pos, mass, targets, eps=0.0, chunk=ORACLE_CHUNK):
    """The float64 direct sum (direct_acc_pot_np's arithmetic: the self
    pair excluded by index) at the sampled `targets` (NumPy indices) over
    every particle, on the card in passes of `chunk` targets. Returns
    NumPy (acc [k, D], pot [k])."""
    p, m = pos.double(), mass.double()
    src = torch.arange(p.shape[0], device=p.device)
    accs, pots = [], []
    for t in torch.as_tensor(targets, device=p.device).split(chunk):
        d = p[None, :, :] - p[t][:, None, :]               # [c, N, D]
        r2 = (d * d).sum(-1) + float(eps) ** 2
        inv_r = torch.where(t[:, None] == src[None, :], 0.0,
                            1.0 / torch.sqrt(r2))
        w = m[None, :] * inv_r
        pots.append(-w.sum(1))
        accs.append(torch.einsum("cn,cnd->cd", w * inv_r * inv_r, d))
        del d, r2, inv_r, w
    return torch.cat(accs).cpu().numpy(), torch.cat(pots).cpu().numpy()


def sampled_oracle(pos, mass, samp, eps=0.0) -> tuple:
    """(acc [k, D], pot [k], oracle_check's record): the float64 direct
    sum at the sampled targets on the card, held to the NumPy one on the
    first of them."""
    acc_o, pot_o = card_oracle(pos, mass, samp, eps)
    return acc_o, pot_o, oracle_check(pos, mass, samp, acc_o, pot_o, eps)


def oracle_check(pos, mass, samp, acc_o, pot_o, eps=0.0) -> dict:
    """card_oracle's sums at the first ORACLE_CHECK targets against
    direct_acc_pot_np's on the host: the largest relative difference of a
    target's force and potential; raises past ORACLE_RTOL."""
    from rakau_tpu_torch import direct_acc_pot_np
    t = samp[:ORACLE_CHECK]
    a, p = direct_acc_pot_np(pos.double().cpu().numpy(),
                             mass.double().cpu().numpy(), eps=eps, targets=t)
    f_rel = float((np.linalg.norm(acc_o[:len(t)] - a, axis=1)
                   / np.linalg.norm(a, axis=1)).max())
    p_rel = float((np.abs(pot_o[:len(t)] - p) / np.abs(p)).max())
    if not (f_rel <= ORACLE_RTOL and p_rel <= ORACLE_RTOL):
        raise AssertionError(f"the card's direct sum against "
                             f"direct_acc_pot_np: force {f_rel:.3e}, pot "
                             f"{p_rel:.3e} (relative), bound {ORACLE_RTOL}")
    return {"targets": len(t), "force_rel": f_rel, "pot_rel": p_rel}


def memory_mb() -> dict:
    """The allocator's peaks since the last reset_peak_memory_stats() and
    the card's memory in use now (mem_get_info: every allocation of the
    process, the allocator's cache included), MB."""
    free, total = torch.cuda.mem_get_info()
    return {"peak_allocated_mb": torch.cuda.max_memory_allocated() / MB,
            "peak_reserved_mb": torch.cuda.max_memory_reserved() / MB,
            "card_used_mb": (total - free) / MB, "card_total_mb": total / MB}


def released():
    """Every graph and cached per-tree query state dropped, the
    allocator's cache handed back, the peaks reset: each path of phase
    scale starts from an empty card."""
    from rakau_tpu_torch import engine
    engine.clear_graphs()
    engine._QUERY_STATE_CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def timed_queries(tree, launches: dict, reps: int = WARM_REPS):
    """(the first query's seconds, the launches its wrappers counted (the
    form counts of `launches`, reset before it: the eager warm-ups and the
    captures), the warm queries' ms, their bookkept launches, the last
    (acc, pot)): accs_pots_o(THETA) once (its graphs captured) and `reps`
    times warm, each timed by CUDA events."""
    for f in launches:
        launches[f] = 0
    _, first_ms = event_ms(lambda: tree.accs_pots_o(THETA))
    wrapper = nonzero({"": launches}).get("", {})
    warm, booked = [], []
    for _ in range(reps):
        (out, ms), counts = counted(
            lambda: event_ms(lambda: tree.accs_pots_o(THETA)))
        warm.append(ms)
        booked.append(counts)
    return first_ms / 1e3, wrapper, warm, booked, out


def query_record(n, build_ms, first_s, warm, acc, pot, oracle, dev) -> dict:
    """The numbers every query of phase scale states."""
    if acc.shape != (n, 3) or pot.shape != (n,):
        raise AssertionError(f"bad shapes {acc.shape} {pot.shape}")
    finite("scale query results", acc, pot)
    warm_ms = statistics.median(warm)
    return dict(n=n, theta=THETA, build_ms=build_ms, first_query_s=first_s,
                warm_query_ms=warm_ms, warm_query_ms_all=warm,
                warm_spread=(max(warm) - min(warm)) / warm_ms,
                evals_per_s=n / (warm_ms / 1e3),
                **sampled_errors(acc, pot, *oracle, dev))


def scale_shared(pos, mass, oracle, dev) -> tuple:
    """The main path at SCALE_N: octree(..., **TREE_KW).accs_pots_o(0.75),
    its first query (captures) and WARM_REPS graphed warm queries; K1a
    launches a warm query = the chunk evaluations and nothing else; the
    accuracy bounds; K1a against its plain version on chunk 0 and on the
    last live chunk. Returns the record and the kernel's row."""
    from rakau_tpu_torch import engine, grid, octree
    from rakau_tpu_torch.config import OVF_FIELDS
    from rakau_tpu_torch.kernels import shared
    n = pos.shape[0]
    released()
    tree, build_ms = synced_ms(lambda: octree(coords=pos, masses=mass,
                                              **TREE_KW))
    first_s, wrapper, warm, booked, (acc, pot) = timed_queries(
        tree, shared.launches)
    td, cfg = tree.tree_data, tree.config
    chunks = engine.live_chunks(td, cfg)
    evaluated = query_chunks(td, cfg)
    for c in booked:
        k1_launches(c, evaluated, ("mono",), "scale: shared warm query")
    if wrapper.get("mono", 0) <= 0:
        raise AssertionError(f"scale: the first shared query's wrappers "
                             f"counted {wrapper}, no K1a")
    rec = query_record(n, build_ms, first_s, warm, acc, pot, oracle, dev)
    rec.update(
        grid_level=grid.effective_grid_level(cfg, n), n_nodes=tree.n_nodes,
        n_tiles=int(td.n_tiles), tile_cap=cfg.tile_capacity(n),
        live_chunks=chunks, chunk_evaluations=evaluated,
        launches_per_warm_query=evaluated, wrapper_launches=wrapper,
        caps={f: getattr(cfg, f) for f in OVF_FIELDS},
        caps_grown={f: getattr(cfg, f) for f in OVF_FIELDS
                    if getattr(cfg, f) != TREE_KW[f]},
        **memory_mb())
    del acc, pot
    # K1a against its plain version on the first and the last live chunk
    krow = kernel_row(td, cfg, chunks, n)
    rec["kernel"] = krow["chunks"]
    emit("scale_shared", **rec)
    if not (rec["force_rms"] < FORCE_RMS_MAX and rec["pot_rms"] < POT_RMS_MAX):
        raise AssertionError(f"scale shared accuracy: force rms "
                             f"{rec['force_rms']:.3e}, pot rms "
                             f"{rec['pot_rms']:.3e}")
    row = dict(launches=evaluated, **{k: krow[k] for k in KERNEL_KEYS})
    del tree, td
    return rec, row


def scale_gwalk(pos, mass, oracle, shared_rms, dev) -> tuple:
    """gwalk+grid at SCALE_N, sized as bench.py sizes it (gwalk_tree): its
    first query and WARM_REPS warm ones, one K2 launch each and nothing
    else; the accuracy bounds, and the force RMS at most 1 + SHARED_RMS_RTOL
    times the shared query's; K2 against its plain version; the pool's
    rows. Returns the record and the kernel's row.

    With farfield "grid" the two engines are not one computation, so
    their errors are not held within 1 % both ways as gwalk_quad holds
    the "m2p" pair: the shared engine applies a tile's accepted nodes
    through its local Taylor expansion, gwalk as M2P rows of its pool on
    every target, and gwalk is the more accurate (1.615e-3 against
    1.733e-3 at 1M on an H100, 7 % apart; the reference's engines do the
    same)."""
    from rakau_tpu_torch import engine, grid
    from rakau_tpu_torch.config import TreeConfig
    from rakau_tpu_torch.kernels import pool
    n = pos.shape[0]
    released()
    (tree, sizing), sizing_ms = synced_ms(lambda: gwalk_tree(
        pos, mass, TreeConfig(farfield="grid", **gwalk_kw(n))))
    td, cfg = tree.tree_data, tree.config
    first_s, wrapper, warm, booked, (acc, pot) = timed_queries(
        tree, pool.launches)
    for c in booked:
        one_launch(c, "mono", "scale: gwalk warm query")
    if wrapper.get("mono", 0) <= 0:
        raise AssertionError(f"scale: the first gwalk query's wrappers "
                             f"counted {wrapper}, no K2")
    rec = query_record(n, sizing.pop("build_ms"), first_s, warm, acc, pot,
                       oracle, dev)
    rec.update(sizing, sizing_ms=sizing_ms,
               grid_level=grid.effective_grid_level(cfg, n),
               n_nodes=tree.n_nodes, live_chunks=engine.live_chunks(td, cfg),
               launches_per_warm_query=1, wrapper_launches=wrapper,
               shared_force_rms=shared_rms, **memory_mb())
    del acc, pot
    inputs = engine.pool_inputs(td, cfg, THETA, 0.0)
    window, block = cfg.pool_window, cfg.pool_block
    tpos, tidx, ppos, pmass = inputs[:4]
    sched = inputs[5].long()
    seg = pool_segments(inputs, n, window, block)
    ends = (sched[:, 0] * (window // block) + sched[:, 1]
            + sched[:, 2] + sched[:, 3]) * block
    rec["pool"] = dict(segments=seg, rows=int(ppos.shape[0]),
                       rows_written=int(ends.max()),
                       rows_in_segments=seg["rows"],
                       rows_live=int((pmass > 0).sum()),
                       windows=int(sched[:, 0].max()) + 1)
    # K2 against its plain version on SCALE_POOL_TILES tiles about the
    # pool's first window boundary, not on every tile: the kernel's
    # windowed addressing is what the scale can break, and a range that
    # crosses a boundary reads both windows, while the plain version over
    # all of the 8M pool takes ~8x the 1.5 s it takes at 1M (the 1M pool
    # is held whole in the main group's kernel phase)
    real = torch.nonzero(tidx[:, 0] < n).squeeze(1)
    cross = int(torch.nonzero(sched[real, 0] > 0)[0, 0])
    lo = max(0, cross - SCALE_POOL_TILES // 2)
    tiles = real[lo:lo + SCALE_POOL_TILES]
    got = pool.eval_pool_fused(
        *inputs[:6], window, scal(0.0, 1.0, inputs[0]), block)
    plain_pool(inputs, tiles[:8], window, block, compensated=False,
               mode="both", quad=False)
    want, pm = synced_ms(lambda: plain_pool(
        inputs, tiles, window, block, compensated=False, mode="both",
        quad=False))
    err = compare((got[0][tiles], got[1][tiles]), want)
    km = cuda_ms(lambda: pool.eval_pool_fused(
        *inputs[:6], window, scal(0.0, 1.0, inputs[0]), block), 10)
    b, b_by = pool_bound(inputs, n, window, block, False, False)
    rec["kernel"] = dict(
        max_abs_err=err, ms=km, plain_ms=pm, plain_tiles=len(tiles),
        plain_windows=sorted({int(w) for w in sched[tiles, 0]}),
        bound_ms=b, bound_by=b_by, pct_of_bound=100 * b / km,
        shape=pool_shape(inputs, window, block, False, False))
    emit("scale_gwalk", **rec)
    if not (rec["force_rms"] < FORCE_RMS_MAX and rec["pot_rms"] < POT_RMS_MAX
            and rec["force_rms"] <= (1 + SHARED_RMS_RTOL) * shared_rms):
        raise AssertionError(f"scale gwalk accuracy: force rms "
                             f"{rec['force_rms']:.3e} (shared "
                             f"{shared_rms:.3e}), pot rms "
                             f"{rec['pot_rms']:.3e}")
    if len(rec["kernel"]["plain_windows"]) < 2:
        raise AssertionError("scale gwalk: the plain K2 range does not "
                             "cross a window boundary")
    row = dict(launches=1, max_abs_err=err, ms=km, plain_ms=pm, bound_ms=b,
               bound_by=b_by, plain_on=f"{len(tiles)} of {seg['tiles']} "
               "tiles, about the pool's first window boundary")
    del tree, td, inputs, got, want
    return rec, row


def scale_leapfrog(seed: int, dev) -> tuple:
    """BASELINE config #2 at SCALE_LF_N as benchmarks/configs.py:90-128
    runs it: the energy configuration's caps sized through the Tree
    (grow and retry, from SCALE_E_CAPS), E0, SCALE_LF_STEPS steps of
    leapfrog_step_morton_host_safe (retries reported), the first step's
    query on the initial state (the step's cfg as it came out of the first
    step) against the float64 direct sum, E after the steps; drift,
    force and energy-potential bounds; K1d+K1b against its plain version
    on the energy tree's first chunk. Returns the record and the kernel's
    row."""
    from rakau_tpu_torch import Tree, engine, integrate, particles
    from rakau_tpu_torch.config import OVF_FIELDS, TreeConfig
    from rakau_tpu_torch.kernels import shared
    n = SCALE_LF_N
    released()
    shared.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.cold_sphere(n, generator=gen)
    state0 = state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)
    cfg = TreeConfig(**LF_KW)
    ecfg0 = cfg.with_(multipole_order=2, accum="compensated", farfield="m2p",
                      **SCALE_E_CAPS)
    samp = np.sort(np.random.default_rng(seed + 1).choice(n, 256,
                                                          replace=False))
    acc_o, pot_o = card_oracle(pos, mass, samp, LF_EPS)
    rec = {"n": n, "steps": SCALE_LF_STEPS, "dt": LF_DT, "theta": LF_THETA,
           "energy_theta": E_THETA, "eps": LF_EPS, "box": LF_BOX}
    torch.cuda.reset_peak_memory_stats()
    # the energy configuration's caps, as the 1M phase sizes them
    etree, size_ms = synced_ms(lambda: Tree(coords=pos, masses=mass,
                                            config=ecfg0, box_size=LF_BOX))
    epot, esize_ms = synced_ms(lambda: etree.pots_o(E_THETA, LF_EPS))
    grown = etree.config
    fitted = etree.tune_caps(slack=1.25)
    ecfg = grown.with_(**{f: max(getattr(grown, f), getattr(fitted, f))
                          for f in OVF_FIELDS})
    _, e_rms = sampled_rms(None, epot, None, pot_o, samp, dev)
    del epot
    rec.update(energy_build_first_ms=size_ms, energy_sizing_query_ms=esize_ms,
               energy_caps_grown={f: getattr(grown, f) for f in OVF_FIELDS
                                  if getattr(grown, f) != getattr(ecfg0, f)},
               energy_caps={f: getattr(ecfg, f) for f in OVF_FIELDS})
    e0, e0_ms = synced_ms(lambda: integrate.total_energy_host(
        state, ecfg, E_THETA, LF_EPS, box_size=LF_BOX))
    step_ms, retries, grown_to = [], [], []
    for _ in range(SCALE_LF_STEPS):
        (state, _, _, cfg, r), ms = synced_ms(
            lambda: integrate.leapfrog_step_morton_host_safe(
                state, LF_DT, cfg, LF_THETA, LF_EPS, box_size=LF_BOX))
        step_ms.append(ms)
        retries.append(r)
        if r:
            grown_to.append({f: getattr(cfg, f) for f in OVF_FIELDS})
    for t in state:
        finite("scale config #2 state", t)
    # the wrappers' launches over the sizing, E0 and the steps (the eager
    # warm-ups and the captures of their graphs)
    wrapper = nonzero({"K1": shared.launches}).get("K1", {})
    # the first step's query: the step configuration on the initial state
    # (its build and query)
    (acc, pot, ovf), q_ms = synced_ms(lambda: integrate.acc_pot_host(
        state0.pos, state0.mass, cfg, LF_THETA, LF_EPS, box_size=LF_BOX))
    if bool(ovf.any()):
        raise AssertionError("scale config #2: the step's query overflowed")
    finite("scale config #2 step query", acc, pot)
    f_rms, p_rms = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
    del acc, pot
    (e2, counts), e2_ms = synced_ms(lambda: counted(
        lambda: integrate.total_energy_host(state, ecfg, E_THETA, LF_EPS,
                                            box_size=LF_BOX)))
    e_chunks = query_chunks(etree.tree_data, ecfg)
    drift = abs(e2 - e0) / abs(e0)
    _, sbuild_ms = synced_ms(lambda: engine.build_tree(
        state.pos, state.mass, cfg, LF_BOX))
    _, ebuild_ms = synced_ms(lambda: engine.build_tree(
        state.pos, state.mass, ecfg, LF_BOX))
    rec.update(e0=e0, e_after=e2, drift=drift, energy_query_ms_first=e0_ms,
               energy_query_ms=e2_ms, energy_launches=counts["K1"],
               energy_chunks=e_chunks, step_ms=step_ms,
               step_first_ms=step_ms[0], step_warm_ms=step_ms[-1],
               cap_retries=retries, caps_grown_to=grown_to,
               step_caps={f: getattr(cfg, f) for f in OVF_FIELDS},
               acc_pot_host_ms=q_ms, step_build_ms=sbuild_ms,
               energy_build_ms=ebuild_ms, force_rms=f_rms, pot_rms=p_rms,
               energy_pot_rms=e_rms, wrapper_launches=wrapper,
               **memory_mb())
    if not (counts["K1"]["quad_comp"] == counts["K1"]["mono_comp"]
            == e_chunks > 0 and wrapper.get("quad_comp", 0) > 0
            and wrapper.get("mono", 0) > 0):
        raise AssertionError(f"scale config #2: energy query launches "
                             f"{counts}, chunks {e_chunks}; by the "
                             f"wrappers {wrapper}")
    forms = energy_kernels(etree, ecfg, ("quad_comp",), "energy (scale)")
    rec["kernel"] = forms["quad_comp"]
    emit("scale_config2", **rec)
    if not (drift < DRIFT_MAX and f_rms < LF_FORCE_RMS_MAX
            and p_rms < LF_POT_RMS_MAX and e_rms < E_POT_RMS_MAX):
        raise AssertionError(f"scale config #2: drift {drift:.3e}, step "
                             f"force rms {f_rms:.3e}, pot rms {p_rms:.3e}, "
                             f"energy pot rms {e_rms:.3e}")
    row = dict(launches=counts["K1"]["quad_comp"], **forms["quad_comp"])
    del etree, state, state0
    return rec, row


def scale(seed: int, dev) -> dict:
    """Phase group scale: the 8M Plummer sphere through the shared and
    the gwalk engine (one sampled float64 oracle on the card, checked
    against direct_acc_pot_np) and config #2 at 1 << 23, every graph of
    the earlier groups released first. Returns the kernels' 8M rows."""
    from rakau_tpu_torch import particles
    t0 = time.perf_counter()
    released()
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(SCALE_N, generator=gen)
    samp = np.sort(np.random.default_rng(seed + 1).choice(
        SCALE_N, 256, replace=False))
    (acc_o, pot_o, check), oracle_ms = synced_ms(lambda: sampled_oracle(
        pos, mass, samp))
    oracle = (acc_o, pot_o, samp)
    part_s = {"oracle": time.perf_counter() - t0}
    t = time.perf_counter()
    srec, k1a = scale_shared(pos, mass, oracle, dev)
    part_s["shared"] = time.perf_counter() - t
    t = time.perf_counter()
    grec, k2 = scale_gwalk(pos, mass, oracle, srec["force_rms"], dev)
    part_s["gwalk"] = time.perf_counter() - t
    del pos, mass
    t = time.perf_counter()
    lrec, k1db = scale_leapfrog(seed + 2, dev)
    part_s["config2"] = time.perf_counter() - t
    released()
    emit("scale", n=SCALE_N, config2_n=SCALE_LF_N, oracle_ms=oracle_ms,
         oracle_check=check, part_s=part_s,
         peak_allocated_mb={"shared": srec["peak_allocated_mb"],
                            "gwalk": grec["peak_allocated_mb"],
                            "config2": lrec["peak_allocated_mb"]},
         seconds=time.perf_counter() - t0)
    return {"K1a": k1a, "K2": k2, "K1d+K1b": k1db}


# ---------------------------------------------------------- phase configs
# BASELINE.json's configurations that group scale does not run, as
# benchmarks/configs.py runs them, at the reference's own sizes on one
# card: #0, 16,384 Plummer particles (configs.py:35-60); #1, a 1M uniform
# cube through the whole integrate.acc_pot at each softening of the sweep
# (:62-78); #3, a 1 << 26 disk galaxy with compensated sums: a build, the
# rebuild of its Morton-ordered positions after a drift, one query
# (:147-182); #4, the weak-scaling cube at the reference's single-chip
# point, 1 << 23 (:184-205, PLAN.md:188-190), through the sharded _host
# twin on a one-card mesh of one shard (the whole twin would capture every
# capacity chunk, ROADMAP item 30). Group ladder runs #4 over four cards.
CFG0_N, CFG1_N, CFG3_N, CFG4_N = 16384, 1 << 20, 1 << 26, 1 << 23
CFG0_KW = dict(max_depth=12, max_leaf_n=32, ncrit=128, tile_chunk=64,
               p2p_leaf_cap=2048)
CFG1_KW = dict(max_depth=12, max_leaf_n=32, ncrit=512, tile_chunk=32,
               p2p_leaf_cap=4096, p2p_src_cap=32768)
CFG1_EPS = (0.0, 1e-3, 1e-2)
CFG3_KW = dict(max_depth=14, max_leaf_n=32, ncrit=512, tile_chunk=32,
               p2p_leaf_cap=4096, p2p_src_cap=49152, m2p_cap=12288,
               accum="compensated")
CFG3_DRIFT = 1e-4
CFG4_KW = dict(max_depth=10, max_leaf_n=64, ncrit=256, tile_chunk=64,
               p2p_leaf_cap=2048)
# each configuration's query starts from the caps that a run of this group
# grew configs.py's to on the card (each grown query: 10-23 s at 1M-64M;
# #4 took three doublings), as SCALE_E_CAPS does; a cap that still
# overflows grows again, and every record names the caps beside
# configs.py's
CFG_CAPS = {0: dict(p2p_src_cap=16384), 1: dict(m2p_cap=8192),
            3: dict(p2p_leaf_cap=8192), 4: dict(p2p_src_cap=65536)}
# the disk's bounds. Its error exceeds the Plummer bounds and grows with
# N, in the reference and the port alike (equal on the CPU, RMS at 256
# targets, DISK_ERRORS: N -> (force, potential);
# tests/test_torch_configs.py), and the reference never ran 1 << 26 (its
# chip ran out of memory; configs.py logs no error): the bound is 1.1 x
# the reference's error extrapolated along log2 N through its two largest
# runs to CFG3_N
DISK_ERRORS = {8192: (1.303e-2, 3.199e-3), 65536: (1.911e-2, 6.027e-3),
               262144: (2.247e-2, 7.227e-3)}


def disk_bound(k: int) -> float:
    """1.1 x DISK_ERRORS' k-th error at CFG3_N, on the line through its
    two largest N in log2 N."""
    (n0, e0), (n1, e1) = sorted((n, e[k]) for n, e in DISK_ERRORS.items())[-2:]
    slope = (e1 - e0) / (math.log2(n1) - math.log2(n0))
    return 1.1 * (e1 + slope * (math.log2(CFG3_N) - math.log2(n1)))


DISK_FORCE_RMS_MAX, DISK_POT_RMS_MAX = disk_bound(0), disk_bound(1)
# the cube (#1, #4) takes LF_FORCE_RMS_MAX, the uniform bound, and 2e-3
# (the reference's own there on 16,384: 2.3-2.5e-3 / 1.2-1.7e-4)
CUBE_POT_RMS_MAX = 2e-3


def grow_to_fit(cfg, flags, maxima):
    """cfg with each capacity whose overflow flag is set doubled until it
    exceeds the maximum the query measured (an overflowed walk may
    undercount: the query is run again and grows again if it must)."""
    from rakau_tpu_torch.config import OVF_FIELDS
    mx = dict(zip(("m2p_cap", "p2p_src_cap", "frontier_cap",
                   "p2p_leaf_cap"), maxima))
    grown = {}
    for f, hit in zip(OVF_FIELDS, flags):
        if hit:
            c = 2 * getattr(cfg, f)
            while c <= mx[f]:
                c *= 2
            grown[f] = c
    return cfg.with_(**grown)


def config_of(k: int, kw: dict):
    """Config #k: configs.py's TreeConfig (kw) with CFG_CAPS[k]."""
    from rakau_tpu_torch.config import TreeConfig
    return TreeConfig(**{**kw, **CFG_CAPS[k]})


def until_fits(query, cfg, what: str, base=None, tries: int = 4,
               grow=None):
    """(query(cfg)'s result, its seconds, the cfg that held every row, its
    caps that differ from those of `base` (configs.py's; default cfg),
    the flagged queries' seconds): query(cfg) returns (acc, pot, overflow
    flags [4], maxima [4] or None) and is run again with the flagged caps
    grown until no flag is set, as Tree._query does, at most `tries`
    queries in all: by grow(cfg, flags, maxima) where given, else by
    grow_to_fit (doubled without maxima)."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.config import OVF_FIELDS, grow_overflowed
    flagged = []
    cfg0 = cfg if base is None else base
    for _ in range(tries):
        out, ms = synced_ms(lambda: query(cfg))
        flags = out[2].cpu().tolist()
        if not any(flags):
            return (out, ms / 1e3, cfg,
                    {f: getattr(cfg, f) for f in OVF_FIELDS
                     if getattr(cfg, f) != getattr(cfg0, f)}, flagged)
        flagged.append(ms / 1e3)
        mx = None if out[3] is None else out[3].cpu().tolist()
        cfg = (grow(cfg, flags, mx) if grow is not None
               else grow_overflowed(cfg, flags) if mx is None
               else grow_to_fit(cfg, flags, mx))
        # the flagged configuration's graphs serve no later call: drop
        # them before the grown one captures its own beside them
        del out
        engine.clear_graphs()
        emit("caps_grown", what=what, flags=flags, seconds=ms / 1e3,
             maxima=mx, caps={f: getattr(cfg, f) for f in OVF_FIELDS})
    raise AssertionError(f"{what}: still overflowing after {tries} "
                         f"queries (flags {flags})")


def bounded(what, f_rms, p_rms, f_max, p_max):
    if not (f_rms < f_max and p_rms < p_max):
        raise AssertionError(f"{what}: force rms {f_rms:.3e} (bound "
                             f"{f_max}), pot rms {p_rms:.3e} (bound "
                             f"{p_max})")


def kernel_row(td, cfg, chunks, n, theta: float = THETA,
               quad: bool = False) -> dict:
    """K1 against its plain version on the first and the last of a query
    of td's `chunks` live chunks at theta, timed: the form the query
    launches on the whole source row (K1a; K1b with compensated sums;
    K1c, K1c+K1b with grid2's cell test), or with `quad` the quadrupole
    form on the node rows [0, U) (K1c+K1d, K1c+K1d+K1b with grid2). The
    kernels line's row, each chunk's record under "chunks"."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import shared
    comp = cfg.accum == "compensated"
    rows = []
    for ch in sorted({0, chunks - 1}):
        inp = engine.kernel_inputs(td, cfg, theta, 0.0, ch)
        args, squad, scell, tcell = inp[:6], inp[6], inp[7], inp[8]
        del inp
        kw = dict(compensated=comp)
        if quad:
            U = squad.shape[0]
            args = args[:2] + tuple(t[:U] for t in args[2:5]) \
                + (args[5][:, :U].contiguous(),)
            kw["src_quad"] = squad
        cells = None
        if scell is not None:
            cells = (scell[:args[2].shape[0]], tcell, cfg.grid_sep)
            kw.update(src_cell=cells[0], tgt_cell=tcell,
                      grid_sep=cfg.grid_sep)
        s = scal(0.0, 1.0, args[0])
        err = compare(shared.eval_shared_fused(*args, s, **kw),
                      shared.eval_shared_plain(*args, s, **kw))
        km = cuda_ms(lambda: shared.eval_shared_fused(*args, s, **kw), 10)
        pm = cuda_ms(lambda: shared.eval_shared_plain(*args, s, **kw), 1)
        b, b_by = bound(args + ((squad,) if quad else ()), n, quad=quad,
                        comp=comp, cells=cells)
        rows.append(dict(chunk=ch, S=int(args[2].shape[0]),
                         max_abs_err=err, ms=km, plain_ms=pm, bound_ms=b,
                         bound_by=b_by, pct_of_bound=100 * b / km,
                         **k1_shape(args, comp, quad, cells)))
        del args, squad, scell, tcell, kw, cells
    return {"chunks": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": float(np.mean([r["ms"] for r in rows])),
            "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
            "bound_ms": float(np.mean([r["bound_ms"] for r in rows])),
            "bound_by": max((r["bound_ms"], r["bound_by"])
                            for r in rows)[1]}


def config0(seed: int, dev) -> dict:
    """#0: 16,384 Plummer particles, engine.build_tree + engine.acc_pot_u
    (whole, as configs.py:46-49 jits it), configs.py's caps grown where
    the query flags them; every target against direct_acc_pot_np."""
    from rakau_tpu_torch import engine, particles
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(CFG0_N, generator=gen,
                                  dtype=torch.float32)
    cfg = config_of(0, CFG0_KW)
    torch.cuda.reset_peak_memory_stats()
    td, build_ms = synced_ms(lambda: engine.build_tree(pos, mass, cfg))
    if bool(td.overflow):
        raise AssertionError("config #0: the build overflowed")
    (acc, pot, _, _), first_s, cfg, grown, flagged = until_fits(
        lambda c: engine.acc_pot_u(td, c, THETA, 0.0, 1.0, with_stats=True),
        cfg, "config #0", TreeConfig(**CFG0_KW))
    (out, warm_ms), counts = counted(lambda: synced_ms(
        lambda: engine.acc_pot_u(td, cfg, THETA, 0.0, 1.0)))
    if not torch.equal(out[0], acc) or not torch.equal(out[1], pot):
        raise AssertionError("config #0: two replays differ")
    chunks = -(-td.tile_begin.shape[0] // min(cfg.tile_chunk,
                                               td.tile_begin.shape[0]))
    k1_launches(counts, chunks, ("mono",), "config #0 warm query")
    finite("config #0", acc, pot)
    # every target: the float64 direct sum on the card (direct_acc_pot_np
    # on the host took 17 s here), held to direct_acc_pot_np on 8 targets
    every = np.arange(CFG0_N)
    a_o, p_o, check = sampled_oracle(td.pos, td.mass, every)
    f_rms, p_rms = sampled_rms(acc, pot, a_o, p_o, every, dev)
    rec = dict(n=CFG0_N, theta=THETA, eps=0.0, build_ms=build_ms,
               first_call_s=first_s, warm_ms=warm_ms,
               evals_per_s=CFG0_N / (warm_ms / 1e3),
               caps_grown=grown, flagged_queries_s=flagged,
               launches=nonzero(counts), capacity_chunks=chunks,
               force_rms=f_rms, pot_rms=p_rms, targets=CFG0_N,
               oracle_check=check, **memory_mb())
    emit("config0", **rec)
    bounded("config #0", f_rms, p_rms, FORCE_RMS_MAX, POT_RMS_MAX)
    return rec


def config1(seed: int, dev) -> dict:
    """#1: a 1M uniform cube through the whole integrate.acc_pot (the build
    and the query one CUDA graph) at eps 0, 1e-3 and 1e-2: the first
    softening captures, the others replay the same graph (eps its input)
    and capture nothing; each result bit-equal to the same call run
    eagerly (graph=False); the oracle at 256 targets for each eps."""
    from rakau_tpu_torch import engine, integrate, particles
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.uniform_cube(CFG1_N, generator=gen,
                                       dtype=torch.float32)
    cfg = config_of(1, CFG1_KW)
    samp = np.sort(np.random.default_rng(seed + 1).choice(
        CFG1_N, 256, replace=False))
    torch.cuda.reset_peak_memory_stats()
    rec = {"n": CFG1_N, "theta": THETA, "eps": {}}
    for i, eps in enumerate(CFG1_EPS):
        engine._GRAPHS.reset_tally()

        def call(c, eps=eps):
            return integrate.acc_pot(pos, mass, c, THETA, eps) + (None,)
        grew = cfg
        (acc, pot, _, _), first_s, cfg, grown, flagged = until_fits(
            call, cfg, f"config #1 eps {eps}", TreeConfig(**CFG1_KW))
        captures = engine._GRAPHS.captures
        if i > 0 and (captures or cfg != grew):
            raise AssertionError(f"config #1: eps {eps} captured "
                                 f"{captures} graphs (grown {grown}): a "
                                 "new softening must replay")
        warm = []
        for _ in range(2):
            # counted() sets the graph cache's tally to zero first
            ((a2, p2, _), ms), counts = counted(lambda: synced_ms(
                lambda: integrate.acc_pot(pos, mass, cfg, THETA, eps)))
            warm.append(ms)
            if engine._GRAPHS.captures:
                raise AssertionError("config #1: a warm call captured")
        eager, eager_ms = synced_ms(lambda: integrate.acc_pot(
            pos, mass, cfg, THETA, eps, graph=False))
        if not (torch.equal(eager[0], acc) and torch.equal(eager[1], pot)
                and torch.equal(a2, acc) and torch.equal(p2, pot)):
            raise AssertionError(f"config #1 eps {eps}: the graphed call "
                                 "and graph=False differ")
        finite(f"config #1 eps {eps}", acc, pot)
        a_o, p_o = card_oracle(pos, mass, samp, eps)
        f_rms, p_rms = sampled_rms(acc, pot, a_o, p_o, samp, dev)
        warm_ms = statistics.median(warm)
        rec["eps"][str(eps)] = dict(
            first_call_s=first_s, captures=captures, warm_ms=warm,
            eager_ms=eager_ms, evals_per_s=CFG1_N / (warm_ms / 1e3),
            caps_grown=grown, flagged_queries_s=flagged,
            launches=nonzero(counts), bit_equal_to_eager=True,
            force_rms=f_rms, pot_rms=p_rms)
        del acc, pot, a2, p2, eager
    rec.update(memory_mb())
    emit("config1", **rec)
    for eps, r in rec["eps"].items():
        bounded(f"config #1 eps {eps}", r["force_rms"], r["pot_rms"],
                LF_FORCE_RMS_MAX, CUBE_POT_RMS_MAX)
    return rec


def config3(seed: int, dev) -> tuple:
    """#3: 1 << 26 disk particles, compensated: engine.build_tree (which
    captures), the Morton-ordered positions drifted by CFG3_DRIFT x a
    normal deviate, the timed rebuild (the same key: a replay), then
    engine.acc_pot_u_host on it, its first call (caps grown where flagged)
    and one warm call; K1b launched once a chunk evaluation; the oracle at
    256 targets; K1b against its plain version. Returns the record and
    the kernel's row."""
    from rakau_tpu_torch import engine, particles
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = CFG3_N
    pos, mass = particles.disk_galaxy(n, generator=gen, dtype=torch.float32)
    cfg = config_of(3, CFG3_KW)
    mem = {}

    def stage(name):
        """The allocator's state after a stage, on a line of its own (the
        memory plan's table, there even where a later stage fails)."""
        mem[name] = memory_mb()
        emit("config3_memory", stage=name, **mem[name])
        torch.cuda.reset_peak_memory_stats()

    stage("particles")
    engine._GRAPHS.reset_tally()
    td, build_ms = synced_ms(lambda: engine.build_tree(pos, mass, cfg))
    stage("build")
    del pos, mass
    if bool(td.overflow):
        raise AssertionError("config #3: the build overflowed")
    drift = CFG3_DRIFT * torch.randn(td.pos.shape, generator=gen,
                                     device=dev)
    pos2 = td.pos + drift
    mass2 = td.mass
    del drift, td
    captured = engine._GRAPHS.captures
    td2, rebuild_ms = synced_ms(lambda: engine.build_tree(pos2, mass2, cfg))
    if engine._GRAPHS.captures != captured or bool(td2.overflow):
        raise AssertionError("config #3: the rebuild captured or "
                             "overflowed")
    del pos2, mass2
    # configs.py's flow: the build's graph stays in the cache beside the
    # query's (its inputs, its TreeData, 4.9 GB at 64M, and its share of
    # the graph pool)
    stage("rebuild")
    samp = np.sort(np.random.default_rng(seed + 1).choice(n, 256,
                                                          replace=False))
    # passes of 2 targets: [2, N, 3] float64 panels of 3.2 GB at 64M
    acc_o, pot_o = card_oracle(td2.pos, td2.mass, samp, chunk=2)
    torch.cuda.empty_cache()
    stage("oracle")

    def query(c):
        return engine.acc_pot_u_host(td2, c, THETA, 0.0, 1.0)
    (acc, pot, _, mx), first_s, cfg, grown, flagged = until_fits(
        query, cfg, "config #3", TreeConfig(**CFG3_KW))
    del acc, pot
    stage("first query")
    ((acc, pot, ovf, _), warm_ms), counts = counted(
        lambda: synced_ms(lambda: query(cfg)))
    if bool(ovf.any()):
        raise AssertionError("config #3: the warm query overflowed")
    chunks = query_chunks(td2, cfg)
    k1_launches(counts, chunks, ("mono_comp",), "config #3 warm query")
    finite("config #3", acc, pot)
    f_rms, p_rms = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
    stage("warm query")
    del acc, pot
    rec = dict(n=n, theta=THETA, eps=0.0, accum=cfg.accum, drift=CFG3_DRIFT,
               build_ms=build_ms, rebuild_ms=rebuild_ms,
               first_call_s=first_s, warm_ms=warm_ms,
               evals_per_s=n / (warm_ms / 1e3), caps_grown=grown,
               flagged_queries_s=flagged, maxima=mx.cpu().tolist(),
               n_tiles=int(td2.n_tiles), tile_cap=cfg.tile_capacity(n),
               live_chunks=engine.live_chunks(td2, cfg),
               chunk_evaluations=chunks, launches=nonzero(counts),
               force_rms=f_rms, pot_rms=p_rms, memory_mb=mem)
    row = kernel_row(td2, cfg, engine.live_chunks(td2, cfg), n)
    rec["kernel"] = row
    emit("config3", **rec)
    bounded("config #3", f_rms, p_rms, DISK_FORCE_RMS_MAX, DISK_POT_RMS_MAX)
    del td2
    return rec, dict(launches=chunks,
                     **{k: row[k] for k in KERNEL_KEYS})


def config4(seed: int, dev) -> tuple:
    """#4 on one card: 1 << 23 cube particles through
    sharded.acc_pot_sharded_host on a one-card mesh of one shard (caps
    grown where flagged), bit-equal to integrate.acc_pot_host on the same
    particles, the oracle at 256 targets; K1a against its plain version
    at these shapes. Returns the record and the kernel's row."""
    from rakau_tpu_torch import engine, integrate, particles
    from rakau_tpu_torch.config import TreeConfig
    from rakau_tpu_torch.parallel import sharded
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = CFG4_N
    pos, mass = particles.uniform_cube(n, generator=gen, dtype=torch.float32)
    cfg = config_of(4, CFG4_KW)
    mesh = sharded.default_mesh(1)
    torch.cuda.reset_peak_memory_stats()

    def call(c):
        return sharded.acc_pot_sharded_host(pos, mass, c, THETA, 0.0, 1.0,
                                            mesh) + (None,)
    (acc, pot, _, _), first_s, cfg, grown, flagged = until_fits(
        call, cfg, "config #4", TreeConfig(**CFG4_KW))
    ((a2, p2, _), warm_ms), counts = counted(lambda: synced_ms(
        lambda: sharded.acc_pot_sharded_host(pos, mass, cfg, THETA, 0.0,
                                             1.0, mesh)))
    one, one_ms = synced_ms(lambda: integrate.acc_pot_host(
        pos, mass, cfg, THETA, 0.0, 1.0))
    if not (torch.equal(a2, acc) and torch.equal(p2, pot)
            and torch.equal(one[0], acc) and torch.equal(one[1], pot)):
        raise AssertionError("config #4: the sharded call on one shard and "
                             "integrate.acc_pot_host differ")
    del a2, p2, one
    td = engine.build_tree(pos, mass, cfg)
    chunks = query_chunks(td, cfg)
    k1_launches(counts, chunks, ("mono",), "config #4 warm call")
    finite("config #4", acc, pot)
    samp = np.sort(np.random.default_rng(seed + 1).choice(n, 256,
                                                          replace=False))
    a_o, p_o = card_oracle(pos, mass, samp)
    f_rms, p_rms = sampled_rms(acc, pot, a_o, p_o, samp, dev)
    del acc, pot
    rec = dict(n=n, theta=THETA, eps=0.0, shards=1, first_call_s=first_s,
               warm_ms=warm_ms, acc_pot_host_ms=one_ms,
               evals_per_s=n / (warm_ms / 1e3), caps_grown=grown,
               flagged_queries_s=flagged, n_tiles=int(td.n_tiles),
               chunk_evaluations=chunks, launches=nonzero(counts),
               bit_equal_to_acc_pot_host=True, force_rms=f_rms,
               pot_rms=p_rms, **memory_mb())
    row = kernel_row(td, cfg, engine.live_chunks(td, cfg), n)
    rec["kernel"] = row
    emit("config4", **rec)
    bounded("config #4", f_rms, p_rms, LF_FORCE_RMS_MAX, CUBE_POT_RMS_MAX)
    del td
    return rec, dict(launches=chunks, **{k: row[k] for k in KERNEL_KEYS})


def configs(seed: int, dev) -> dict:
    """Phase group configs: BASELINE configs #0, #1, #3 and #4 (one card),
    every earlier graph released first. Returns the kernels' rows."""
    t0 = time.perf_counter()
    part_s = {}
    out = {}
    for name, fn in (("config0", config0), ("config1", config1),
                     ("config3", config3), ("config4", config4)):
        released()
        t = time.perf_counter()
        res = fn(seed + len(part_s), dev)
        part_s[name] = time.perf_counter() - t
        if name in ("config3", "config4"):
            out[name] = res[1]
    released()
    emit("configs", part_s=part_s, seconds=time.perf_counter() - t0)
    return out


# -------------------------------------------------------- phase accuracy
# lmac+grid2, the reference's accuracy engine (PLAN.md:298-305), at the
# reference's own sizes on one card: the headline stage lmac8m of
# benchmarks/tpu_session.py (:33-37 on bench.py:54-78), 8,388,608 Plummer
# particles through LMAC_KW at theta 0.75, the grid level (6) by the
# occupancy rule; lmac8m_l7, the same particles at grid level 7
# (tpu_session.py:38-43); and the accuracy ladder at 1,048,576
# (benchmarks/ladder.py's configuration, PLAN.md:279-294)
ACC8M_N, ACC8M_L7 = 1 << 23, 7
ACC_N, ACC_TARGETS = 1 << 20, 2048
# ladder.py's rung configuration (ladder.py:73-86): lmac+grid2,
# grid_multipole_order = local_order, a group table of 65,536 rows and
# its 1M starting caps; frontier_cap 4096 on another traversal
ACC_KW = dict(max_depth=14, max_leaf_n=32, ncrit=512, tile_chunk=32,
              traversal_mode="lmac", farfield="grid2", frontier_cap=65536,
              m2p_cap=16384, p2p_leaf_cap=16384, p2p_src_cap=131072)
# the rungs, (local order p, grid multipole order q, grid_sep, theta,
# multipole_order, other fields): o4/s2 monopole (a), o6/s3 quadrupole at
# the headline theta (b) and the same through the shared traversal (c),
# o8/s3 quadrupole with compensated sums at theta 0.5 (d; PLAN.md:284-290)
# and o8/s4 at theta 0.4 (e; PLAN.md:233-234)
ACC_RUNGS = {
    "a": (4, 4, 2, 0.75, 0, {}),
    "b": (6, 6, 3, 0.75, 2, {}),
    "c": (6, 6, 3, 0.75, 2, dict(traversal_mode="shared",
                                 frontier_cap=4096)),
    "d": (8, 8, 3, 0.5, 2, dict(accum="compensated")),
    "e": (8, 8, 4, 0.4, 2, dict(accum="compensated")),
}
# a rung's flagged capacities grow this many times over, at most this
# many times (ladder.py:96-107)
ACC_GROW, ACC_GROW_TRIES = 4, 3
# the ladder's bounds on force RMS (ladder_bounds): (b) under the
# reference's gate at the headline theta (PLAN.md:292-293), (d) under
# ACC_D_MAX and under (b), (b) at most ACC_RATIO x (c), (e) at most
# ACC_RATIO x (d), (a) under FORCE_RMS_MAX
ACC_B_MAX, ACC_D_MAX, ACC_RATIO = 3e-4, 1e-4, 1.1


def rung_kw(name: str) -> dict:
    """Ladder rung `name`'s TreeConfig fields (its theta is
    ACC_RUNGS[name][3])."""
    p, q, sep, _, mpole, extra = ACC_RUNGS[name]
    return {**ACC_KW, "local_order": p, "grid_multipole_order": q,
            "grid_sep": sep, "multipole_order": mpole, **extra}


def ladder_bounds(f: dict) -> dict:
    """The ladder's bounds on the rungs' force RMS `f` ({rung: RMS}), each
    whose rungs are all in f: {bound: held}."""
    rules = ((f"a < {FORCE_RMS_MAX}", "a", lambda: f["a"] < FORCE_RMS_MAX),
             (f"b < {ACC_B_MAX}", "b", lambda: f["b"] < ACC_B_MAX),
             (f"b <= {ACC_RATIO} c", "bc",
              lambda: f["b"] <= ACC_RATIO * f["c"]),
             ("d < b", "bd", lambda: f["d"] < f["b"]),
             (f"d < {ACC_D_MAX}", "d", lambda: f["d"] < ACC_D_MAX),
             (f"e <= {ACC_RATIO} d", "de",
              lambda: f["e"] <= ACC_RATIO * f["d"]))
    return {text: bool(held()) for text, need, held in rules
            if all(r in f for r in need)}


def far_field_alone(td, cfg) -> dict:
    """grid2's leaf locals of td at cfg's level and orders, made alone
    between device syncs (the tables already made): ms, the allocator's
    peak above what was held before (the pyramid, each level's M2L
    kernels and convolution buffers, the L2L chain) and the locals' MB.
    Resets the peak statistics."""
    from rakau_tpu_torch import grid2
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (Lleaf, _), ms = synced_ms(lambda: grid2.leaf_locals(td, cfg, 0.0))
    return dict(grid_level=grid2.effective_grid_level(cfg, td.pos.shape[0]),
                leaf_locals_ms=ms,
                leaf_locals_peak_mb=(torch.cuda.max_memory_allocated()
                                     - base) / MB,
                leaf_locals_mb=Lleaf.numel() * Lleaf.element_size() / MB)


def acc_lmac8m(pos, mass, oracle, dev) -> tuple:
    """Path lmac8m: octree(..., **LMAC_KW).accs_pots_o(THETA) on the
    ACC8M_N particles: its first query (the Tree grows what overflows),
    tune_caps, then the tuned caps' first query and WARM_REPS graphed warm
    ones (timed_queries), K1c (mono_cell) launches a warm query = the
    chunk evaluations and nothing else; the flags and maxima of the tuned
    query (none set; the group table's rows under its cap); the accuracy
    bounds; K1c against its plain version on chunk 0 and the last live
    chunk; the leaf locals alone; then the shared engine's first query
    with the same far field, level and theta on the same tree (its caps
    grown where flagged, until_fits), lmac's force RMS at most
    LMAC_SHARED_RATIO x its.
    Returns the record, the tree and the K1c row."""
    from rakau_tpu_torch import engine, grid2, octree
    from rakau_tpu_torch.config import OVF_FIELDS, TreeConfig
    from rakau_tpu_torch.kernels import shared
    n = pos.shape[0]
    released()
    tree, build_ms = synced_ms(lambda: octree(coords=pos, masses=mass,
                                              **LMAC_KW))
    _, grow_ms = event_ms(lambda: tree.accs_pots_o(THETA))
    grown = {f: getattr(tree.config, f) for f in OVF_FIELDS
             if getattr(tree.config, f) != LMAC_KW[f]}
    tree.tune_caps()
    first_s, wrapper, warm, booked, (acc, pot) = timed_queries(
        tree, shared.launches)
    td, cfg = tree.tree_data, tree.config
    chunks = engine.live_chunks(td, cfg)
    evaluated = query_chunks(td, cfg)
    for c in booked:
        k1_launches(c, evaluated, ("mono_cell",), "lmac8m warm query")
    _, _, ovf, mx = engine.acc_pot_u_host(td, cfg, THETA, 0.0)
    ovf, mx = ovf.cpu().tolist(), mx.cpu().tolist()
    rec = query_record(n, build_ms, first_s, warm, acc, pot, oracle, dev)
    del acc, pot
    rec.update(
        farfield="grid2", local_order=cfg.local_order, grid_sep=cfg.grid_sep,
        grid_level=grid2.effective_grid_level(cfg, n),
        first_query_with_growth_s=grow_ms / 1e3, caps_grown=grown,
        caps={f: getattr(cfg, f) for f in OVF_FIELDS}, maxima=mx,
        overflow=ovf, n_nodes=tree.n_nodes, n_tiles=int(td.n_tiles),
        live_chunks=chunks, chunk_evaluations=evaluated,
        slices=len(engine._slices(chunks, cfg.tile_chunk)),
        launches_per_warm_query=[c["K1"]["mono_cell"] for c in booked],
        wrapper_launches=wrapper, **memory_mb())
    if any(ovf) or not 0 < mx[2] < cfg.frontier_cap:
        raise AssertionError(f"lmac8m: maxima {mx}, overflow {ovf}, group "
                             f"table cap {cfg.frontier_cap}")
    row = kernel_row(td, cfg, chunks, n)
    rec["kernel"] = row.pop("chunks")
    rec["far_field"] = far_field_alone(td, cfg)
    # the shared engine beside it: the same far field, level and theta
    released()
    scfg = TreeConfig(**LMAC_KW).with_(traversal_mode="shared",
                                       frontier_cap=TREE_KW["frontier_cap"])
    (sacc, spot, _, _), s_s, scfg, _, s_flagged = until_fits(
        lambda c: engine.acc_pot_u_host(td, c, THETA, 0.0), scfg,
        "lmac8m shared")
    s_err = sampled_errors(sacc[td.inv_perm], spot[td.inv_perm], *oracle,
                           dev)
    rec.update(shared_force_rms=s_err["force_rms"],
               shared_pot_rms=s_err["pot_rms"],
               shared_first_query_s=s_s + sum(s_flagged),
               shared_flagged_s=s_flagged,
               shared_caps={f: getattr(scfg, f) for f in OVF_FIELDS},
               shared_grid_level=grid2.effective_grid_level(scfg, n),
               force_rms_over_shared=rec["force_rms"] / s_err["force_rms"])
    del sacc, spot
    released()
    emit("lmac8m", **rec)
    bounded("lmac8m", rec["force_rms"], rec["pot_rms"], FORCE_RMS_MAX,
            POT_RMS_MAX)
    if not rec["force_rms"] <= LMAC_SHARED_RATIO * s_err["force_rms"]:
        raise AssertionError(f"lmac8m force rms {rec['force_rms']:.3e} "
                             f"above {LMAC_SHARED_RATIO} x the shared "
                             f"engine's {s_err['force_rms']:.3e}")
    return rec, tree, dict(launches=evaluated,
                           **{k: row[k] for k in KERNEL_KEYS})


def acc_lmac8m_l7(tree, oracle, dev) -> dict:
    """Path lmac8m_l7: the lmac8m tree at grid level ACC8M_L7 (2,097,152
    leaf cells: the M2L convolution at its largest) through
    engine.acc_pot_u_host, as bench.py queries the tree it built, from
    the lmac8m run's tuned caps (grown where flagged, until_fits):
    the per-tree query state made alone (tiles, tables, leaf locals) and
    the leaf locals alone with their peak memory, then the first query and
    WARM_REPS graphed warm ones (K1c launches = the chunk evaluations),
    the flags and maxima (none set), the accuracy bounds."""
    from rakau_tpu_torch import engine, grid2
    from rakau_tpu_torch.config import OVF_FIELDS
    td = tree.tree_data
    n = td.pos.shape[0]
    released()
    cfg0 = tree.config.with_(grid_level=ACC8M_L7)
    _, state_ms = synced_ms(lambda: engine._query_state(td, cfg0, 0.0))
    state_mb = memory_mb()
    far = far_field_alone(td, cfg0)
    torch.cuda.reset_peak_memory_stats()
    (_, _, _, mx), first_s, cfg, _, flagged = until_fits(
        lambda c: engine.acc_pot_u_host(td, c, THETA, 0.0), cfg0,
        "lmac8m_l7")
    first_s += sum(flagged)
    evaluated = query_chunks(td, cfg)
    warm, booked = [], []
    for _ in range(WARM_REPS):
        ((acc, pot, ovf, _), ms), counts = counted(lambda: event_ms(
            lambda: engine.acc_pot_u_host(td, cfg, THETA, 0.0)))
        warm.append(ms)
        booked.append(counts)
        k1_launches(counts, evaluated, ("mono_cell",), "lmac8m_l7 warm "
                    "query")
    ovf = ovf.cpu().tolist()
    acc, pot = acc[td.inv_perm], pot[td.inv_perm]
    rec = query_record(n, None, first_s, warm, acc, pot, oracle, dev)
    del acc, pot
    chunks = engine.live_chunks(td, cfg)
    rec.update(grid_level=grid2.effective_grid_level(cfg, n),
               leaf_cells=(1 << ACC8M_L7) ** 3, tree="lmac8m's",
               query_state_ms=state_ms,
               query_state_peak_mb=state_mb["peak_allocated_mb"],
               far_field=far, flagged_s=flagged,
               caps={f: getattr(cfg, f) for f in OVF_FIELDS},
               maxima=mx.cpu().tolist(),
               overflow=ovf, live_chunks=chunks,
               chunk_evaluations=evaluated,
               slices=len(engine._slices(chunks, cfg.tile_chunk)),
               launches_per_warm_query=[c["K1"]["mono_cell"]
                                        for c in booked], **memory_mb())
    released()
    emit("lmac8m_l7", **rec)
    if any(ovf):
        raise AssertionError(f"lmac8m_l7: overflow {ovf}")
    bounded("lmac8m_l7", rec["force_rms"], rec["pot_rms"], FORCE_RMS_MAX,
            POT_RMS_MAX)
    return rec


def ladder_grow(cfg, flags, maxima):
    """cfg with each flagged capacity ACC_GROW times over (ladder.py's
    growth)."""
    from rakau_tpu_torch.config import OVF_FIELDS
    return cfg.with_(**{f: ACC_GROW * getattr(cfg, f)
                        for f, hit in zip(OVF_FIELDS, flags) if hit})


def rung_forms(cfg) -> tuple:
    """The K1 forms a query of cfg (grid2) launches once a chunk
    evaluation: the quadrupole one on the node rows and the monopole one
    on the particle rows, or the monopole one on the whole row."""
    comp = "_comp" if cfg.accum == "compensated" else ""
    forms = (f"mono{comp}_cell",)
    if cfg.multipole_order >= 2:
        forms = (f"quad{comp}_cell",) + forms
    return forms


def accuracy_ladder(seed: int, dev) -> tuple:
    """The accuracy ladder at ACC_N particles: for each rung of ACC_RUNGS
    its configuration (rung_kw) on the tree engine.build_tree makes of the
    particles (one a multipole order), engine.acc_pot_u_host grown as
    ladder.py grows it (until_fits with ladder_grow, at most
    ACC_GROW_TRIES times), then one graphed warm query counted
    (each form of rung_forms once a chunk evaluation, nothing else); the
    leaf locals alone; the float64 oracle at ACC_TARGETS targets; rung b's
    and d's quadrupole form against its plain version on chunk 0. An
    accuracy_rung line each, then the bounds (ladder_bounds). Returns the
    records and the kernels line's rows."""
    from rakau_tpu_torch import engine, particles
    from rakau_tpu_torch.config import OVF_FIELDS, TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(ACC_N, generator=gen)
    samp = np.sort(np.random.default_rng(seed + 1).choice(
        ACC_N, ACC_TARGETS, replace=False))
    (acc_o, pot_o, check), oracle_ms = synced_ms(lambda: sampled_oracle(
        pos, mass, samp))
    oracle = (acc_o, pot_o, samp)
    trees, recs, rows = {}, {}, {}
    for name, (p, q, sep, theta, mpole, extra) in ACC_RUNGS.items():
        t0 = time.perf_counter()
        released()
        cfg0 = TreeConfig(**rung_kw(name))
        if mpole not in trees:
            trees[mpole] = synced_ms(lambda: engine.build_tree(pos, mass,
                                                               cfg0))
            if bool(trees[mpole][0].overflow):
                raise AssertionError(f"rung {name}: the build overflowed")
        td, build_ms = trees[mpole]
        (_, _, _, mx), first_s, cfg, grown, flagged = until_fits(
            lambda c: engine.acc_pot_u_host(td, c, theta, 0.0), cfg0,
            f"accuracy rung {name}", tries=ACC_GROW_TRIES + 1,
            grow=ladder_grow)
        evaluated = query_chunks(td, cfg)
        ((acc, pot, ovf, _), warm_ms), counts = counted(lambda: event_ms(
            lambda: engine.acc_pot_u_host(td, cfg, theta, 0.0)))
        k1_launches(counts, evaluated, rung_forms(cfg), f"rung {name} warm "
                    "query")
        ovf = ovf.cpu().tolist()
        acc, pot = acc[td.inv_perm], pot[td.inv_perm]
        finite(f"rung {name} result", acc, pot)
        err = sampled_errors(acc, pot, *oracle, dev)
        del acc, pot
        rec = dict(rung=name, n=ACC_N, p=p, q=q, grid_sep=sep, theta=theta,
                   multipole_order=mpole, accum=cfg.accum,
                   traversal_mode=cfg.traversal_mode, **err,
                   build_ms=build_ms, first_query_s=first_s + sum(flagged),
                   flagged_s=flagged, warm_query_ms=warm_ms,
                   caps={f: getattr(cfg, f) for f in OVF_FIELDS},
                   caps_grown=grown, maxima=mx.cpu().tolist(),
                   overflow=ovf, n_tiles=int(td.n_tiles),
                   chunk_evaluations=evaluated,
                   launches={f: counts["K1"][f] for f in rung_forms(cfg)},
                   **memory_mb())
        if any(ovf):
            raise AssertionError(f"rung {name}: overflow {ovf}")
        rec["far_field"] = far_field_alone(td, cfg)
        if name in ("b", "d"):
            row = kernel_row(td, cfg, 1, ACC_N, theta, quad=True)
            rec["kernel"] = row.pop("chunks")
            rows[name] = dict(launches=counts["K1"][rung_forms(cfg)[0]],
                              **{k: row[k] for k in KERNEL_KEYS})
        rec["seconds"] = time.perf_counter() - t0
        emit("accuracy_rung", **rec)
        recs[name] = rec
    del trees, pos, mass
    released()
    held = ladder_bounds({r: recs[r]["force_rms"] for r in recs})
    return recs, rows, dict(oracle_ms=oracle_ms, oracle_check=check,
                            bounds=held)


def accuracy(seed: int, dev) -> dict:
    """Phase group accuracy: lmac8m and lmac8m_l7 on one set of ACC8M_N
    Plummer particles (one sampled float64 oracle on the card, checked
    against direct_acc_pot_np), then the accuracy ladder at ACC_N, every
    earlier graph released first. Every path must be finite and end with
    no flag set; the bounds of each path and of the ladder are held after
    its records are printed. Returns the kernels' rows."""
    from rakau_tpu_torch import particles
    t0 = time.perf_counter()
    released()
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(ACC8M_N, generator=gen)
    samp = np.sort(np.random.default_rng(seed + 1).choice(
        ACC8M_N, 256, replace=False))
    (acc_o, pot_o, check), oracle_ms = synced_ms(lambda: sampled_oracle(
        pos, mass, samp))
    oracle = (acc_o, pot_o, samp)
    part_s = {"oracle": time.perf_counter() - t0}
    t = time.perf_counter()
    rec8, tree, k1c = acc_lmac8m(pos, mass, oracle, dev)
    part_s["lmac8m"] = time.perf_counter() - t
    del pos, mass
    t = time.perf_counter()
    rec7 = acc_lmac8m_l7(tree, oracle, dev)
    part_s["lmac8m_l7"] = time.perf_counter() - t
    del tree
    released()
    t = time.perf_counter()
    recs, rows, lrec = accuracy_ladder(seed + 2, dev)
    part_s["ladder"] = time.perf_counter() - t
    emit("accuracy", n=ACC8M_N, ladder_n=ACC_N, oracle_ms=oracle_ms,
         oracle_check=check, ladder_oracle_ms=lrec["oracle_ms"],
         ladder_oracle_check=lrec["oracle_check"],
         force_rms={"lmac8m": rec8["force_rms"],
                    "lmac8m_l7": rec7["force_rms"],
                    **{r: v["force_rms"] for r, v in recs.items()}},
         ladder_bounds=lrec["bounds"], part_s=part_s,
         seconds=time.perf_counter() - t0)
    broken = [b for b, held in lrec["bounds"].items() if not held]
    if broken or len(lrec["bounds"]) != 6:
        raise AssertionError(f"accuracy ladder: bounds {lrec['bounds']}")
    return {"lmac8m": k1c, "rung_b": rows["b"], "rung_d": rows["d"]}


# ---------------------------------------------------------- phase ladder
# BASELINE config #4 over four cards at its weak-scaling sizes: 2^28
# particles over a v5p-16's eight chips is 2^25 a chip. The replicated
# path (sharded.acc_pot_sharded, configs.py:184-206) builds all N on card
# 0, so 2^25 a card (2^27 on card 0) is not run on it (PERF.md section 7);
# the _host twin runs at each size of LADDER_PER_CARD, the whole staged
# twin (one CUDA graph a card and stage) at the first.
LADDER_CARDS = 4
LADDER_PER_CARD = (1 << 23, 1 << 24)
# config #4's caps as a four-card run grew them at 2^23 a card (m2p 4096
# -> 8192, p2p_leaf 2048 -> 4096) beside CFG_CAPS[4]: each rung starts
# from them, and a cap that still overflows grows again
LADDER_CAPS = dict(CFG_CAPS[4], m2p_cap=8192, p2p_leaf_cap=4096)
# The LET on #4's cube, phase0 "distributed". Its Morton-range domain
# boxes overlap on the cube as on a Plummer sphere (the sample-sort
# splitters cut a few cells off a neighbour's range, and their AABB spans
# it), so a shard exports about its whole range to some neighbour and
# imports E = ndev x export_cap >= 8 nl rows; every tile of the local
# tree (3 nl rows with the exchange's slots) takes them all, a [64, E]
# far/near gate and M2L a chunk: the time grows as nl^2. 2^16 a card
# (262,144 in all) is what the group's time holds beside the replicated
# path (PERF.md section 7 reckons 2^17 to 2^25 a card); the whole staged
# twin runs at the first size.
LET_LADDER_PER_CARD = (1 << 16,)


def let_walk_caps(nl: int) -> dict:
    """The export walk's caps for nl rows a shard on #4's cube, twice or
    more what the walk measured there (2^14 to 2^18 rows a shard on the
    CPU): particle rows up to ~1.02 nl (a shard exports about its whole
    range), opened leaves up to nl / 16, frontier up to nl / 127,
    accepted nodes under 2,000."""
    return dict(export_node_cap=max(8192, nl // 16),
                export_part_cap=1 << (2 * nl - 1).bit_length(),
                export_leaf_cap=max(4096, nl // 4),
                export_frontier_cap=max(1024, nl // 32))


def reset_card_peaks(cards: int):
    for d in range(cards):
        torch.cuda.reset_peak_memory_stats(d)


def card_memory(cards: int) -> dict:
    """Each card's peak allocated and reserved MiB since the last reset,
    the MiB its graphs' pools hold now, and the MiB each of its graphs
    pins (static inputs, outputs) by function."""
    from rakau_tpu_torch import engine
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0):
            pools[seg["device"]] = pools.get(seg["device"], 0) + seg[
                "total_size"]
    pinned = {}
    for k, g in engine._GRAPHS._graphs.items():
        by_fn = pinned.setdefault(k[2][0][2].index, {})
        io = by_fn.setdefault(k[0].__name__, [0.0, 0.0])
        io[0] += sum(t.nbytes for t in g.inputs) / MB
        io[1] += sum(t.nbytes for t in g.outputs) / MB
    return {"peak_mb_by_card": {d: torch.cuda.max_memory_allocated(d) / MB
                                for d in range(cards)},
            "peak_reserved_mb_by_card": {
                d: torch.cuda.max_memory_reserved(d) / MB
                for d in range(cards)},
            "graph_pool_mb_by_card": {d: pools.get(d, 0) / MB
                                      for d in range(cards)},
            "pinned_in_out_mb_by_card": pinned}


def ladder_oracle(pos, mass, seed: int) -> tuple:
    """The sampled float64 oracle (card_oracle) at 256 targets, in passes
    small enough beside what a rung keeps on card 0 at 2^26 particles."""
    n = pos.shape[0]
    samp = np.sort(np.random.default_rng(seed).choice(n, 256, replace=False))
    return card_oracle(pos, mass, samp, chunk=max(1, (1 << 28) // n)) + (
        samp,)


def ladder_host(pos, mass, mesh, cfg0, what: str,
                profile: bool = True) -> tuple:
    """sharded.acc_pot_sharded_host on `mesh` from cfg0, caps grown where
    flagged (until_fits): the first call, a warm call (MB the collectives
    copied; its K1a by bookkeeping), with profile a profiled call (K1a
    and busy ms a card), each bit-equal to the first. Returns (acc, pot,
    the cfg that fit, the record)."""
    from rakau_tpu_torch.config import TreeConfig
    from rakau_tpu_torch.parallel import mesh as _mesh
    from rakau_tpu_torch.parallel import sharded

    def call(c):
        return sharded.acc_pot_sharded_host(pos, mass, c, THETA, 0.0, 1.0,
                                            mesh) + (None,)
    (acc, pot, ovf, _), first_s, cfg, grown, flagged = until_fits(
        call, cfg0, what, TreeConfig(**CFG4_KW))
    _mesh.reset_copied()
    ((a2, p2, _), warm_ms), booked = counted(
        lambda: all_synced_ms(lambda: call(cfg)[:3]))
    copied = sum(_mesh.copied.values())
    outs, prof = [(a2, p2)], {"k1a_launches_booked": booked["K1"]["mono"]}
    if profile:
        (a3, p3, _), prof = card_profile(lambda: call(cfg)[:3])
        outs.append((a3, p3))
    if not all(torch.equal(a, acc) and torch.equal(p, pot) for a, p in outs):
        raise AssertionError(f"{what}: two calls differ")
    finite(what, acc, pot)
    return acc, pot, cfg, dict(
        first_call_s=first_s, warm_ms=warm_ms,
        evals_per_s=pos.shape[0] / (warm_ms / 1e3), caps_grown=grown,
        flagged_queries_s=flagged, overflow=ovf.tolist(),
        mb_copied=copied / MB, **prof)


def ladder_whole(pos, mass, mesh, cfg, host: tuple, cards: int) -> dict:
    """The whole staged sharded.acc_pot_sharded on `mesh` (the build's
    graph and the tiles and tables on card 0, each card's range of the
    padded capacity chunks as one CUDA graph on that card, the tail on
    card 0): its first call (the host seconds of each card's warm-ups and
    captures, the graphs' pools and pins a card) and a warm call (its K1a
    by bookkeeping), each bit-equal to the _host twin's sums (host). Not
    profiled, for the group's time (a profile of its ~4,100 chunks'
    kernels, like the 2^24 rung's, most likely takes minutes to read)."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.parallel import sharded

    def call():
        return sharded.acc_pot_sharded(pos, mass, cfg, THETA, 0.0, 1.0, mesh)
    reset_card_peaks(cards)
    engine._GRAPHS.reset_tally()
    out, first_ms = all_synced_ms(call)
    first = dict(first_call_s=first_ms / 1e3,
                 capture_s_by_card=dict(engine._GRAPHS.capture_s),
                 captures=engine._GRAPHS.captures, **card_memory(cards))
    (out2, warm_ms), booked = counted(lambda: all_synced_ms(call))
    for o in (out, out2):
        if not (torch.equal(o[0], host[0]) and torch.equal(o[1], host[1])
                and not o[2].any()):
            raise AssertionError("ladder whole acc_pot_sharded: not "
                                 "bit-equal to the _host twin")
    return dict(first=first, warm_ms=warm_ms,
                evals_per_s=pos.shape[0] / (warm_ms / 1e3),
                k1a_launches_booked=booked["K1"]["mono"],
                bit_equal_to_host=True)


def ladder_replicated(seed: int, mesh, per_cards) -> list:
    """The replicated path at each size of per_cards a card: the _host
    twin (ladder_host; profiled at the first size only: profiled, the
    2^24 rung spent ~264 s outside its timed calls, most likely reading
    the profile) and the oracle; at the
    first size the same call on one card (bit-equal; card 0's peak beside
    it) and the whole staged twin (ladder_whole). Returns the rungs'
    records."""
    from rakau_tpu_torch import particles
    from rakau_tpu_torch.parallel import sharded
    cards = torch.cuda.device_count()
    dev0 = mesh.devices[0]
    cfg0 = config_of(4, CFG4_KW).with_(**LADDER_CAPS)
    rungs = []
    for i, per_card in enumerate(per_cards):
        n = per_card * mesh.size
        released()
        reset_card_peaks(cards)
        t = time.perf_counter()
        gen = torch.Generator(device=dev0).manual_seed(seed + i)
        pos, mass = particles.uniform_cube(n, generator=gen,
                                           dtype=torch.float32)
        acc, pot, cfg, rec = ladder_host(pos, mass, mesh, cfg0,
                                         f"ladder {n}", profile=i == 0)
        rung = {"path": "replicated", "twin": "_host", "n": n,
                "per_card": per_card, "shards": mesh.size, **rec,
                **card_memory(cards)}
        if i == 0:
            released()
            one, one_ms = synced_ms(lambda: sharded.acc_pot_sharded_host(
                pos, mass, cfg, THETA, 0.0, 1.0, sharded.default_mesh(1)))
            if not (torch.equal(one[0], acc) and torch.equal(one[1], pot)):
                raise AssertionError(f"ladder {n}: four cards and one card "
                                     "differ")
            rung.update(one_card_ms=one_ms, bit_equal_to_one_card=True,
                        one_card_peak_mb=torch.cuda.max_memory_allocated(
                            dev0) / MB)
            del one
            released()
            rung["whole"] = ladder_whole(pos, mass, mesh, cfg, (acc, pot),
                                         cards)
        released()
        a_o, p_o, samp = ladder_oracle(pos, mass, seed + 100 + i)
        f_rms, p_rms = sampled_rms(acc, pot, a_o, p_o, samp, dev0)
        rung.update(force_rms=f_rms, pot_rms=p_rms,
                    seconds=time.perf_counter() - t)
        emit("ladder_rung", **rung)
        bounded(f"ladder {n}", f_rms, p_rms, LF_FORCE_RMS_MAX,
                CUBE_POT_RMS_MAX)
        rungs.append(rung)
        del acc, pot, pos, mass
    return rungs


def let_fit(pos, mass, mesh, cfg, caps: dict, what: str) -> tuple:
    """let.acc_pot_let_host with_stats, its export_cap sized from one
    call's counts (the power of two above the largest; the walk's caps
    doubled where the counts fit and the export overflow is set), the
    query's caps doubled where flagged, until a call has no flag and no
    export overflow. Returns (its output, seconds of the calls, caps,
    cfg)."""
    from rakau_tpu_torch.config import grow_overflowed
    from rakau_tpu_torch.parallel import let
    calls = []
    for _ in range(4):
        out, ms = all_synced_ms(lambda: let.acc_pot_let_host(
            pos, mass, cfg, THETA, 0.0, 1.0, mesh, with_stats=True, **caps))
        calls.append(ms / 1e3)
        ovf, xo, cnt = out[2], bool(out[3]), out[4]
        need = 1 << (int(cnt.max()) - 1).bit_length()
        if not ovf.any() and not xo:
            return out, calls, caps, cfg
        emit("caps_grown", what=what, flags=ovf.tolist(), export_ovf=xo,
             max_count=int(cnt.max()), seconds=ms / 1e3)
        if need > caps["export_cap"]:
            caps = dict(caps, export_cap=need)
        elif xo:
            # the counts fit: the walk itself overflowed its caps
            caps = {k: v if k == "export_cap" else 2 * v
                    for k, v in caps.items()}
        cfg = grow_overflowed(cfg, ovf.tolist())
    raise AssertionError(f"{what}: still overflowing at {caps}")


def ladder_let(seed: int, mesh, per_cards) -> list:
    """The LET (phase0 "distributed") at each size of per_cards a card on
    #4's cube: let_fit from LET_CAPS' export_cap and let_walk_caps, a warm
    call (MB copied), a profiled call (K1a and busy ms a card), peaks a
    card, the export matrix and halo bytes; the replicated _host twin on
    the same particles (its card 0 peak and force RMS beside the LET's);
    the oracle. At the first size: phase0 "global" within LET_CROSS_MAX of
    it and the whole staged let.acc_pot_let bit-equal to it."""
    from rakau_tpu_torch import particles
    from rakau_tpu_torch.config import OVF_FIELDS
    from rakau_tpu_torch.parallel import let
    from rakau_tpu_torch.parallel import mesh as _mesh
    cards = torch.cuda.device_count()
    dev0 = mesh.devices[0]
    cfg0 = config_of(4, CFG4_KW).with_(**LADDER_CAPS)
    rungs = []
    for i, per_card in enumerate(per_cards):
        n = per_card * mesh.size
        released()
        reset_card_peaks(cards)
        t = time.perf_counter()
        gen = torch.Generator(device=dev0).manual_seed(seed + i)
        pos, mass = particles.uniform_cube(n, generator=gen,
                                           dtype=torch.float32)
        what = f"ladder let {n}"
        out, fit_s, caps, cfg = let_fit(
            pos, mass, mesh, cfg0,
            dict(export_cap=LET_CAPS["export_cap"], **let_walk_caps(per_card)),
            what)

        def call():
            return let.acc_pot_let_host(pos, mass, cfg, THETA, 0.0, 1.0,
                                        mesh, with_stats=True, **caps)
        _mesh.reset_copied()
        out2, warm_ms = all_synced_ms(call)
        copied = sum(_mesh.copied.values())
        out3, prof = card_profile(call)
        if not all(torch.equal(x, y) for o in (out2, out3)
                   for x, y in zip(o, out)):
            raise AssertionError(f"{what}: two calls differ")
        finite(what, out[0], out[1])
        cnt = out[4]
        item = pos.element_size() * (pos.shape[1] + 1)
        rung = {"path": "let", "twin": "_host", "phase0": "distributed",
                "n": n, "per_card": per_card, "shards": mesh.size,
                "fit_calls_s": fit_s, "caps_used": caps,
                "query_caps": {f: getattr(cfg, f) for f in OVF_FIELDS},
                "warm_ms": warm_ms, "evals_per_s": n / (warm_ms / 1e3),
                "mb_copied": copied / MB, **prof, **card_memory(cards),
                "export_counts": cnt.tolist(),
                "max_count_over_range": int(cnt.max()) / per_card,
                "import_slots": mesh.size * caps["export_cap"],
                "halo_bytes": int(cnt.sum()) * item}
        if i == 0:
            g = let.acc_pot_let_host(pos, mass, cfg, THETA, 0.0, 1.0, mesh,
                                     phase0="global", with_stats=True,
                                     **caps)
            rung["global_vs_distributed_rms"] = rel_rms(out[0], g[0])
            if g[2].any() or g[3] or not (rung["global_vs_distributed_rms"]
                                          < LET_CROSS_MAX):
                raise AssertionError(f"{what} global: {rung}")
            del g
            released()
            rung["whole"] = let_whole_staged(pos, mass, mesh, cfg, caps, out,
                                             cards)
        released()
        reset_card_peaks(cards)
        rep_acc, rep_pot, _, rep = ladder_host(
            pos, mass, mesh, cfg0, f"{what} replicated", profile=False)
        rung["replicated"] = dict(
            warm_ms=rep["warm_ms"], peak_mb_by_card=card_memory(cards)[
                "peak_mb_by_card"])
        released()
        a_o, p_o, samp = ladder_oracle(pos, mass, seed + 100 + i)
        f_rms, p_rms = sampled_rms(out[0], out[1], a_o, p_o, samp, dev0)
        rf_rms, _ = sampled_rms(rep_acc, rep_pot, a_o, p_o, samp, dev0)
        rung.update(force_rms=f_rms, pot_rms=p_rms,
                    replicated_force_rms=rf_rms,
                    let_peak_below_replicated_card0=max(
                        rung["peak_mb_by_card"].values())
                    < rung["replicated"]["peak_mb_by_card"][0],
                    seconds=time.perf_counter() - t)
        emit("ladder_rung", **rung)
        bounded(what, f_rms, p_rms, LF_FORCE_RMS_MAX, CUBE_POT_RMS_MAX)
        if not f_rms <= LET_FORCE_RATIO * rf_rms:
            raise AssertionError(f"{what}: force rms {f_rms:.3e} above "
                                 f"{LET_FORCE_RATIO} x the replicated "
                                 f"path's {rf_rms:.3e}")
        rungs.append(rung)
        del out, out2, out3, rep_acc, rep_pot, pos, mass
    return rungs


def let_whole_staged(pos, mass, mesh, cfg, caps, host, cards: int) -> dict:
    """The whole staged let.acc_pot_let (each stage one CUDA graph a card,
    the local queries over each shard's tile capacity): first call (host
    seconds of each card's warm-ups and captures, pools and pins a card),
    a warm call, each bit-equal to the _host twin's output (host: sums,
    flags, export overflow, counts)."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.parallel import let

    def call():
        return let.acc_pot_let(pos, mass, cfg, THETA, 0.0, 1.0, mesh,
                               with_stats=True, **caps)
    reset_card_peaks(cards)
    engine._GRAPHS.reset_tally()
    out, first_ms = all_synced_ms(call)
    first = dict(first_call_s=first_ms / 1e3,
                 capture_s_by_card=dict(engine._GRAPHS.capture_s),
                 captures=engine._GRAPHS.captures, **card_memory(cards))
    (out2, warm_ms), booked = counted(lambda: all_synced_ms(call))
    for o in (out, out2):
        if not all(torch.equal(x, y) for x, y in zip(o, host)):
            raise AssertionError("ladder whole acc_pot_let: not bit-equal "
                                 "to the _host twin")
    return dict(first=first, warm_ms=warm_ms,
                k1a_launches_booked=booked["K1"]["mono"],
                bit_equal_to_host=True)


def ladder(seed: int, dev0) -> dict:
    """Phase group ladder: BASELINE config #4 on a mesh of a shard a card
    over LADDER_CARDS cards (a skip line with fewer): the replicated path
    at LADDER_PER_CARD a card (ladder_replicated; the whole staged twin at
    the first), then the LET at LET_LADDER_PER_CARD a card (ladder_let;
    its whole staged twin at the first). Every rung must fit and pass:
    any failure, an out-of-memory error among them, fails the run."""
    from rakau_tpu_torch.parallel import sharded
    cards = torch.cuda.device_count()
    if cards < LADDER_CARDS:
        emit("ladder", skipped=f"needs {LADDER_CARDS} cards, {cards} here")
        return {}
    mesh = sharded.default_mesh(LADDER_CARDS)
    part_s = {}
    t = time.perf_counter()
    rungs = ladder_replicated(seed, mesh, LADDER_PER_CARD)
    part_s["replicated"] = time.perf_counter() - t
    t = time.perf_counter()
    rungs += ladder_let(seed + 50, mesh, LET_LADDER_PER_CARD)
    part_s["let"] = time.perf_counter() - t
    released()
    emit("ladder", rungs=[(r["path"], r["per_card"]) for r in rungs],
         part_s=part_s)
    return {"rungs": rungs}


def main_config(pos, mass):
    """The main tree's configuration where phase group "main" did not run:
    octree(...) with TREE_KW and one query, which grows its caps."""
    from rakau_tpu_torch import octree
    tree = octree(coords=pos, masses=mass, **TREE_KW)
    tree.accs_pots_o(THETA)
    return tree.config

def kernels_line(m: dict, lf: dict, forms: dict, big: dict) -> list:
    """The kernels line: every kernel form with its launches on the main
    path, time, plain time and bound (m: main_path's results; lf, forms:
    phase leapfrog's and its energy kernels'; big: groups scale's,
    configs' and accuracy's rows)."""
    (launches, worst, k_ms, p_ms, b_ms, whole_rec, c_launches, c_forms,
     v_forms, v_launches, lv_forms, lv_launches, g_launches, q_launches, k2,
     t_launches, t_forms, f64_launches, f64_forms) = (m[k] for k in (
        "launches", "worst", "k_ms", "p_ms", "b_ms", "whole_rec",
        "c_launches", "c_forms", "v_forms", "v_launches", "lv_forms",
        "lv_launches", "g_launches", "q_launches", "k2", "t_launches",
        "t_forms", "f64_launches", "f64_forms"))
    whole_k1a = {
        f"leapfrog_step_morton (config #2 at {SMALL_N:,})": lf[
            "graphs"]["leapfrog_step"]["k1a_launches_measured"]["whole"],
        "acc_pot (graft entry)": whole_rec["graft entry"]["launches"][
            "K1"]["mono"]}
    whole_quad_comp = {f"total_energy (config #2 at {SMALL_N:,})": lf[
        "graphs"]["total_energy"]["launches_measured"]["whole"]["K1"][
        "quad_comp"]}

    kernels = [{
        "name": "K1a shared_fused (monopole, fp32)", "route": "cuda",
        "source": SRC, "replaces": REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": float(np.mean(k_ms)),
        "plain_ms": float(np.mean(p_ms)),
        # the mean of the chunks' bounds, limited as the larger of them is
        "bound_ms": float(np.mean([b for b, _ in b_ms])),
        "bound_by": max(b_ms)[1], "library_ms": None,
        "whole_call_launches": whole_k1a}]
    for form, name, n_launch in (
            ("mono_comp", "K1b shared_fused (monopole, compensated)",
             lf["energy_launches"]["mono_comp"]),
            ("quad", "K1d shared_fused (quadrupole, fp32)",
             lf["fp32_quad_launches"]["quad"]),
            ("quad_comp", "K1d+K1b shared_fused (quadrupole, compensated)",
             lf["energy_launches"]["quad_comp"])):
        kernels.append({"name": name, "route": "cuda", "source": SRC,
                        "replaces": REPLACES, "launches": n_launch,
                        **forms[form], "library_ms": None})
        if form == "quad_comp":
            kernels[-1]["whole_call_launches"] = whole_quad_comp
    for form, name in (
            ("mono_cell", "K1c shared_fused (monopole, fp32, cell test)"),
            ("mono_comp_cell",
             "K1c+K1b shared_fused (monopole, compensated, cell test)"),
            ("quad_cell", "K1c+K1d shared_fused (quadrupole, fp32, cell "
             "test)"),
            ("quad_comp_cell", "K1c+K1d+K1b shared_fused (quadrupole, "
             "compensated, cell test)")):
        kernels.append({"name": name, "route": "cuda", "source": SRC,
                        "replaces": REPLACES, "launches": c_launches[form],
                        **c_forms[form], "library_ms": None})
    for form, name, n_launch in (
            ("mono", "K2 pool (monopole, fp32)", g_launches),
            ("mono_comp", "K2 pool (monopole, compensated)",
             q_launches["mono_comp"]),
            ("quad", "K2 pool (quadrupole, fp32)", q_launches["quad"]),
            ("quad_comp", "K2 pool (quadrupole, compensated)",
             q_launches["quad_comp"])):
        kernels.append({"name": name, "route": "cuda", "source": POOL_SRC,
                        "replaces": POOL_REPLACES, "launches": n_launch,
                        **{k: v for k, v in k2[form].items()
                           if k in KERNEL_KEYS}, "library_ms": None})
    for forms_, launches_, cell in ((v_forms, v_launches, ""),
                                    (lv_forms, lv_launches, "_cell")):
        for prec in PRECS:
            kernels.append({
                "name": f"K6 shared_mma ({prec}"
                        + (", cell test)" if cell else ")"),
                "route": "cuda", "source": MMA_SRC, "replaces": MMA_REPLACES,
                "launches": launches_[f"mma/{prec}"],
                **forms_[f"mma{cell}/{prec}"], "library_ms": None})
    kernels.append({"name": "K5 shared_blocks (monopole, fp32)",
                    "route": "cuda", "source": BLOCKS_SRC,
                    "replaces": BLOCKS_REPLACES,
                    "launches": v_launches["blocks"], **v_forms["blocks"],
                    "library_ms": None})
    for key, name, replaces in (
            ("K3", "K3 tiles (fused rows, monopole, fp32)", K3_REPLACES),
            ("K4", "K4 tiles pairwise (one launch a row, monopole, fp32)",
             K4_REPLACES)):
        kernels.append({"name": name, "route": "cuda", "source": TILES_SRC,
                        "replaces": replaces, "launches": t_launches[key],
                        **t_forms[key], "library_ms": None})
    for key, name, source, replaces in (
            ("K1a", "K1a shared_fused (monopole, fp64 build)", SRC,
             REPLACES),
            ("K2", "K2 pool (monopole, fp64 build)", POOL_SRC,
             POOL_REPLACES),
            ("K3", "K3 tiles (fused rows, monopole, fp64 build)", TILES_SRC,
             K3_REPLACES),
            ("K4", "K4 tiles pairwise (one launch a row, monopole, fp64 "
             "build)", TILES_SRC, K4_REPLACES)):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": f64_launches[key],
                        **f64_forms[key], "library_ms": None})
    for key, name, source, replaces in (
            ("K1a", f"K1a shared_fused (monopole, fp32, {SCALE_N:,} "
             "particles)", SRC, REPLACES),
            ("K2", f"K2 pool (monopole, fp32, {SCALE_N:,} particles)",
             POOL_SRC, POOL_REPLACES),
            ("K1d+K1b", "K1d+K1b shared_fused (quadrupole, compensated, "
             f"config #2 at {SCALE_LF_N:,})", SRC, REPLACES),
            ("config3", "K1b shared_fused (monopole, compensated, config #3 "
             f"at {CFG3_N:,})", SRC, REPLACES),
            ("config4", "K1a shared_fused (monopole, fp32, config #4 at "
             f"{CFG4_N:,})", SRC, REPLACES),
            ("lmac8m", "K1c shared_fused (monopole, fp32, cell test, lmac8m "
             f"at {ACC8M_N:,})", SRC, REPLACES),
            ("rung_b", "K1c+K1d shared_fused (quadrupole, fp32, cell test, "
             f"ladder rung b: order 6 at {ACC_N:,})", SRC, REPLACES),
            ("rung_d", "K1c+K1d+K1b shared_fused (quadrupole, compensated, "
             f"cell test, ladder rung d: order 8 at {ACC_N:,})", SRC,
             REPLACES)):
        row = big[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, **row,
                        "pct_of_bound": 100 * row["bound_ms"] / row["ms"],
                        "library_ms": None})
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="the phase groups to run, comma-separated, of "
                         + ",".join(PHASES) + " (default: all; the kernels "
                         "line is printed when all run)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES) or "device" not in phases:
        ap.error(f"--phases takes groups of {PHASES}, device among them")
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from rakau_tpu_torch import particles
    from rakau_tpu_torch.kernels import shared

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    group_t = [time.perf_counter()]

    def group_done(name: str):
        """The closing line of a phase group: its seconds."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        emit("group", group=name, seconds=now - group_t[0])
        group_t[0] = now

    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    group_done("device")

    if "build" in phases:
        emit("build", **build_kernels())
        group_done("build")

    if "edge" in phases:
        edge_err, cancel = edge_cases(shared, dev)
        emit("edge", max_abs_err=edge_err, cancellation_err=cancel)
        edge_err, cancel = pool_edge_cases(dev)
        emit("edge_pool", max_abs_err=edge_err, cancellation_err=cancel)
        emit("edge_cell", max_abs_err=cell_edge_cases(shared, dev),
             wide_cells_max_abs_err=wide_cell_cases(shared, dev))
        emit("edge_mma", max_abs_err=mma_edge_cases(shared, dev),
             structure_max_abs_err=k6_structure_cases(shared, dev))
        emit("edge_blocks", max_abs_err=blocks_edge_cases(shared, dev))
        f64 = torch.float64
        k1_err, k1_stair = edge_cases(shared, dev, f64)
        k2_err, k2_stair = pool_edge_cases(dev, f64)
        emit("edge_f64", max_abs_err={
            "K1": k1_err, "K1c": cell_edge_cases(shared, dev, f64),
            "K2": k2_err}, staircase_err_u={"K1": k1_stair, "K2": k2_stair})
        emit("edge_tiles", max_abs_err={
            "float32": tiles_edge_cases(dev, torch.float32),
            "float64": tiles_edge_cases(dev, f64)})
        group_done("edge")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    pos, mass = particles.plummer(args.n, generator=gen)
    # the Plummer sphere of the checks that do not need --n (SMALL_N)
    small = particles.plummer(
        min(SMALL_N, args.n),
        generator=torch.Generator(device=dev).manual_seed(args.seed + 13))
    if "main" in phases:
        m = main_path(args.n, args.seed, pos, mass, small, dev)
        cfg = m["cfg"]
        group_done("main")
    elif phases & {"multi", "multicard"}:
        cfg = main_config(pos, mass)
    torch.cuda.empty_cache()

    # ---- the multi-device paths: F2, sharded query and step, LET ---------
    let_set = None
    if "multi" in phases:
        mrec, let_set = multi(*small, cfg, args.seed + 7, dev,
                              min(LET_N, args.n))
        torch.cuda.empty_cache()
        group_done("multi")
    # ---- the staged pipelines, per card (across the cards where several) -
    if "multicard" in phases:
        multicard(pos, mass, cfg, small, let_set, args.seed + 9, args.n)
        torch.cuda.empty_cache()
        group_done("multicard")

    # ---- BASELINE config #2: the leapfrog harness -----------------------
    kernels = None
    if "leapfrog" in phases:
        lf, etree, ecfg = leapfrog(args.n, args.seed + 2, dev)
        forms = energy_kernels(etree, ecfg)
        del etree
        group_done("leapfrog")
    del pos, mass, small
    # ---- the reference's own sizes: 8M, and config #2 at 1 << 23 --------
    big = {}
    if "scale" in phases:
        big = scale(args.seed + 11, dev)
        group_done("scale")
    # ---- BASELINE configs #0, #1, #3, #4; #4 over four cards ------------
    if "configs" in phases:
        big.update(configs(args.seed + 15, dev))
        group_done("configs")
    # ---- lmac+grid2 at 8,388,608 and its accuracy ladder at 1M ----------
    if "accuracy" in phases:
        big.update(accuracy(args.seed + 19, dev))
        group_done("accuracy")
    if "ladder" in phases:
        ladder(args.seed + 17, dev)
        group_done("ladder")
    if phases == set(PHASES):
        emit("graphs", summary=graphs_summary(
            m["graphs_rec"], mrec, {**m["whole_rec"], **lf["graphs"]}))
        kernels = kernels_line(m, lf, forms, big)
    emit("total", seconds=time.perf_counter() - t_start)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
