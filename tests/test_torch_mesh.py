"""rakau_tpu_torch.parallel.mesh, the collective layer of the multi-device
paths: all_to_all, all_gather, pmax and any on per-shard lists against
NumPy transposes and reductions at 1, 2 and 8 shards, to_shards, and
default_mesh (CPU shards; no card here, so the card default raises); the
grouping of shards by device, the stages run over it in shard order, the
bytes the collectives copy between devices (CPU device labels, which
torch keeps apart), gather_cat's one buffer, and the graph cache's
per-device keys and bound."""
import numpy as np
import pytest
import torch

from rakau_tpu_torch import graphs
from rakau_tpu_torch.parallel import mesh

torch.set_num_threads(1)


def _shards(ndev, shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(ndev)]


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_all_to_all_is_the_block_transpose(ndev):
    xs = _shards(ndev, (ndev, 3, 2), ndev)
    out = mesh.all_to_all([torch.tensor(x) for x in xs])
    want = np.swapaxes(np.stack(xs), 0, 1)        # out[r][s] = xs[s][r]
    assert len(out) == ndev
    for r in range(ndev):
        np.testing.assert_array_equal(out[r].numpy(), want[r])


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_all_gather_stacks_every_shard(ndev):
    xs = _shards(ndev, (5, 3), 10 + ndev)
    out = mesh.all_gather([torch.tensor(x) for x in xs])
    for r in range(ndev):
        np.testing.assert_array_equal(out[r].numpy(), np.stack(xs))


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_pmax_and_any_reduce_over_the_shards(ndev):
    xs = [np.rint(4 * x).astype(np.int64)
          for x in _shards(ndev, (7,), 20 + ndev)]
    bs = [x > 2 for x in xs]
    mx = mesh.pmax([torch.tensor(x) for x in xs])
    an = mesh.any([torch.tensor(b) for b in bs])
    for r in range(ndev):
        np.testing.assert_array_equal(mx[r].numpy(), np.max(xs, axis=0))
        np.testing.assert_array_equal(an[r].numpy(), np.any(bs, axis=0))
        assert an[r].dtype == torch.bool


def test_default_mesh_on_the_cpu():
    m = mesh.default_mesh(4, device="cpu")
    assert m.size == 4 and m.devices == (torch.device("cpu"),) * 4
    assert mesh.default_mesh(device="cpu").size == 1
    # shards sharing a device share one copy
    x = torch.arange(3.0)
    assert all(y is x for y in mesh.to_shards(m, x))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh.default_mesh(2)


def _labels(*idx):
    """A mesh whose shard r sits on the CPU device label idx[r]."""
    return mesh.Mesh(tuple(torch.device("cpu", i) for i in idx))


LAYOUTS = [(0,), (0, 0, 0), (0, 1), (0, 1, 0), (0, 1, 0, 1), (1, 0, 0, 1, 2)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cards_group_the_shards_in_shard_order(layout):
    """Each device once, in the order of its first shard, with its shards
    in shard order; one_card where there is one device."""
    m = _labels(*layout)
    groups = mesh.cards(m)
    assert [d.index for d, _ in groups] == list(dict.fromkeys(layout))
    for dev, shards in groups:
        assert list(shards) == sorted(shards)
        assert all(m.devices[r] == dev for r in shards)
    assert sorted(r for _, rs in groups for r in rs) == list(range(m.size))
    assert mesh.one_card(m) == (len(set(layout)) == 1)


@pytest.mark.parametrize("staged", [None, False])
@pytest.mark.parametrize("layout", [(0, 1, 0), (1, 0, 1, 0)])
def test_stage_map_returns_every_shard_in_order(layout, staged):
    """stage_map gives shard r's result at r whether it loops over the
    shards (None) or runs each device's shards together (False: eagerly,
    as the CPU runs); on_first runs on the first shard."""
    m = _labels(*layout)
    args = [(torch.full((2,), float(r)), r) for r in range(m.size)]
    out = mesh.stage_map(m, lambda x, r: (x + 1, r), args, staged)
    assert [r for _, r in out] == list(range(m.size))
    assert all(torch.equal(x, torch.full((2,), r + 1.0)) for x, r in out)
    assert mesh.on_first(m, torch.neg, staged, torch.ones(1)) == -1


def test_graphed_stages_on_cpu_tensors_raise():
    """staged=True replays CUDA graphs: on CPU tensors it raises, and never
    runs the stage eagerly instead."""
    with pytest.raises(ValueError, match="CUDA"):
        mesh.stage_map(_labels(0, 1), torch.neg,
                       [(torch.ones(1),), (torch.ones(1),)], True)


def test_collectives_count_the_bytes_they_copy():
    """Moves between two device labels are counted (CPU labels copy, as
    cards do); moves on one device, which alias, are not."""
    x = torch.ones(4, 3)
    mesh.reset_copied()
    one = mesh.to_shards(mesh.default_mesh(2, device="cpu"), x)
    assert one[0] is x and not mesh.copied
    mesh.to_shards(_labels(0, 1, 1), x)
    assert sum(mesh.copied.values()) == 2 * x.nbytes
    mesh.reset_copied()
    got = mesh.gather([x, x[:2]], torch.device("cpu", 1))
    assert torch.equal(got[1], x[:2])
    assert sum(mesh.copied.values()) == x.nbytes + x[:2].nbytes
    mesh.reset_copied()


def test_gather_cat_concatenates_in_shard_order():
    """gather_cat: the shards' pieces concatenated on one device, equal to
    torch.cat of the gathered pieces; the bytes moved to another device
    label counted, pieces already on the device not."""
    xs = [torch.tensor(x) for x in _shards(3, (4, 3), 30)]
    xs[2] = xs[2][:2]
    mesh.reset_copied()
    assert torch.equal(mesh.gather_cat(xs, torch.device("cpu")),
                       torch.cat(xs))
    assert not mesh.copied
    assert torch.equal(mesh.gather_cat(xs, torch.device("cpu", 1)),
                       torch.cat(xs))
    assert sum(mesh.copied.values()) == sum(x.nbytes for x in xs)
    mesh.reset_copied()


def test_graph_keys_and_bound_are_per_device():
    """A graph's key holds the device of its tensors (a graph captured on
    one card never serves another), and the cache keeps SIZE graphs a
    device: the least recently used of a full device goes, another
    device's graphs stay."""
    cache = graphs.GraphCache()
    k_cpu = cache.key(torch.neg, (torch.ones(2),), {})[0]
    k_meta = cache.key(torch.neg, (torch.ones(2, device="meta"),), {})[0]
    assert k_cpu != k_meta

    def key(dev, i):
        return (torch.neg, i, (((2,), torch.float32, dev),), ())

    a, b = torch.device("cpu", 0), torch.device("cpu", 1)
    for i in range(graphs.SIZE):
        cache._keep(key(a, i), f"a{i}")
    cache._keep(key(b, 0), "b0")
    assert len(cache) == graphs.SIZE + 1
    cache._keep(key(a, graphs.SIZE), "new")
    assert key(a, 0) not in cache._graphs and key(b, 0) in cache._graphs
    assert len(cache) == graphs.SIZE + 1
