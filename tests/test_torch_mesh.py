"""rakau_tpu_torch.parallel.mesh, the collective layer of the multi-device
paths: all_to_all, all_gather, pmax and any on per-shard lists against
NumPy transposes and reductions at 1, 2 and 8 shards, to_shards, and
default_mesh (CPU shards; no card here, so the card default raises)."""
import numpy as np
import pytest
import torch

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
