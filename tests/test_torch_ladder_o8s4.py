"""The accuracy ladder's rung e (o8/s4 quadrupole with compensated sums
at theta 0.4) through rakau_tpu and the port on one tree
(tests/ladder_cases.py: at its grid level the far field holds no pair),
and the ladder's bound on it in both packages. Rung d, which the bound
"e <= 1.1 d" reads, runs through the port alone (its sums are held to
the reference's in tests/test_torch_ladder_o8.py)."""
import torch

import chip_smoke
from tests import ladder_cases

torch.set_num_threads(1)


def test_rung_matches_the_reference():
    ladder_cases.check_rung("e")


def test_ladder_bound_holds_in_both_packages():
    """chip_smoke.ladder_bounds on rungs d and e (e at most 1.1 x d, d
    under 1e-4) hold for both packages' errors here as on the card."""
    d = ladder_cases.port_rung("d")["force_rms"]
    for side in ("ref", "port"):
        e = ladder_cases.both_rung("e")[side]["force_rms"]
        held = chip_smoke.ladder_bounds({"d": d, "e": e})
        assert len(held) == 2 and all(held.values()), (side, d, e, held)
