"""The accuracy ladder's rung d (o8/s3 quadrupole with compensated sums
at theta 0.5) through rakau_tpu and the port on one tree
(tests/ladder_cases.py), and the ladder's bounds on it in both packages.
Rung b, which the bound "d < b" reads, runs through the port alone (its
sums are held to the reference's in tests/test_torch_ladder.py)."""
import torch

import chip_smoke
from tests import ladder_cases

torch.set_num_threads(1)


def test_rung_matches_the_reference():
    ladder_cases.check_rung("d")


def test_ladder_bounds_hold_in_both_packages():
    """chip_smoke.ladder_bounds on rungs b and d (d below b and under
    1e-4) hold for both packages' errors here as on the card."""
    b = ladder_cases.port_rung("b")["force_rms"]
    for side in ("ref", "port"):
        d = ladder_cases.both_rung("d")[side]["force_rms"]
        held = chip_smoke.ladder_bounds({"b": b, "d": d})
        assert len(held) == 3 and all(held.values()), (side, b, d, held)
