"""Parity of the port's fleet-score scorer with the JAX package's.

The port's ``score_rows`` on a CPU tensor (its plain PyTorch version) is
held bit for bit (atol 0) against the NumPy oracle ``score_rows_ref`` and
the Pallas kernel in interpret mode. On the card, the CUDA kernel is held
against the plain version on the same inputs (marked ``cuda``: skips here).
"""
import numpy as np
import pytest
import torch

from repro.kernels.fleet_score import score_rows as jax_score_rows
from repro.kernels.fleet_score import score_rows_ref
from repro_torch.kernels.fleet_score import score_rows
from repro_torch.kernels.fleet_score import score_rows_ref as plain
from repro_torch.kernels.fleet_score.fleet_score import COUNTER, fleet_score

DIRS = [1.0, 1.0, -1.0, -1.0, -1.0, 1.0, -1.0, -1.0]
SIGN_NAN = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]


def _mats(r, m, n, seed):
    rng = np.random.default_rng(seed)
    mats = rng.random((r, m, n), dtype=np.float32) * 0.1 + 1.0
    mats[:, 0, n - 1] *= 1.5          # planted step-time stragglers
    mats[:, 0, 3] *= 1.3
    mats[:, 0, 7] *= 1.06
    return mats


def _port(mats, dirs, st_j=0):
    dev, rel, contrib = score_rows(torch.from_numpy(mats.copy()), dirs, st_j)
    return dev.numpy(), rel.numpy(), contrib.numpy()


def _assert_same(want, got):
    np.testing.assert_array_equal(want[0], got[0])          # bit-identical
    np.testing.assert_allclose(want[1], got[1], rtol=0, atol=0)
    np.testing.assert_allclose(want[2], got[2], rtol=0, atol=0)


@pytest.mark.parametrize("R,M,N", [(3, 4, 64), (2, 3, 130), (1, 8, 4097)])
def test_matches_numpy_oracle_and_pallas(R, M, N):
    mats = _mats(R, M, N, seed=R * 1000 + N)
    dirs = DIRS[:M]
    got = _port(mats, dirs)
    _assert_same(score_rows_ref(mats, dirs, 0), got)
    _assert_same(jax_score_rows(mats, dirs, 0, backend="pallas"), got)


def test_sign_bit_nans_follow_numpy_oracle():
    """NaNs with the sign bit set (x86's ``inf - inf``) sort last, as
    ``np.partition`` puts them; the Pallas reference keys them below
    -inf and disagrees on some of these rows."""
    rows = []
    for s in range(40):
        rng = np.random.default_rng(s)
        m = rng.random((2, 16), dtype=np.float32) * 0.1 + 1.0
        m[0, 5] *= 1.12
        m[0, rng.choice(16, 2, replace=False)] = SIGN_NAN
        rows.append(m)
    mats = np.stack(rows)
    want = score_rows_ref(mats, [1.0, 1.0], 0)
    _assert_same(want, _port(mats, [1.0, 1.0]))
    pallas = jax_score_rows(mats, [1.0, 1.0], 0, backend="pallas")
    assert not np.array_equal(want[0], pallas[0])


def test_nan_rows_and_no_step_metric():
    mats = _mats(2, 4, 50, seed=3)
    mats[:, 2, :] = np.nan                         # metric without readings
    mats[:, 1, [4, 9, 11]] = np.nan                # sensor dropouts
    mats[1, 0, 20] = SIGN_NAN
    _assert_same(score_rows_ref(mats, DIRS[:4], 0), _port(mats, DIRS[:4]))
    _assert_same(score_rows_ref(mats, DIRS[:4], None),
                 _port(mats, DIRS[:4], st_j=None))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 64, 129])
def test_median_matches_numpy(n):
    from repro_torch.kernels.fleet_score import median_lastdim
    x = np.random.default_rng(n).random((4, 3, n), dtype=np.float32)
    got = median_lastdim(torch.from_numpy(x)).numpy()
    want = np.median(x, axis=-1, keepdims=True).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_kernel_wrapper_refuses_cpu_tensors():
    mats = torch.from_numpy(_mats(1, 2, 16, seed=0))
    before = COUNTER.launches
    with pytest.raises(ValueError):
        fleet_score(mats, [1.0, 1.0], 0, z_threshold=3.0,
                    slowdown_floor=0.025, mad_floor_frac=0.01)
    assert COUNTER.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false); the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,M,N", [(1, 8, 16384), (6, 8, 16384),
                                   (1, 8, 16383), (3, 4, 130)])
def test_kernel_matches_plain_on_card(cuda, R, M, N):
    mats = _mats(R, M, N, seed=N)
    mats[:, 2 % M, ::97] = np.nan
    mats[:, 0, 11] = SIGN_NAN
    t = torch.from_numpy(mats).to(cuda)
    kw = dict(z_threshold=3.0, slowdown_floor=0.025, mad_floor_frac=0.01)
    before = COUNTER.launches
    got = fleet_score(t, DIRS[:M], 0, **kw)
    assert COUNTER.launches == before + 1
    want = plain(t, DIRS[:M], 0, **kw)
    _assert_same(tuple(x.cpu().numpy() for x in want),
                 tuple(x.cpu().numpy() for x in got))
