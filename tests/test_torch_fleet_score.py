"""Parity of the port's fleet-score scorer with the JAX package's.

The port's ``score_rows`` on a CPU tensor (its plain PyTorch version) is
held bit for bit (atol 0) against the NumPy oracle ``score_rows_ref`` and
the Pallas kernel in interpret mode. A numpy emulation of the CUDA
kernel's radix select (four rounds of 8-bit digits, both middle ranks of
an even row in the same rounds) is held to ``np.partition`` on rows with
NaNs, sign-bit NaNs, signed zeros, infinities and ties. On the card, the
CUDA kernel is held against the plain version on the same inputs (marked
``cuda``: skips here).
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


def _keys(x):
    """float32 -> uint32 keys in IEEE total order, NaNs made 0x7fc00000."""
    u = x.view(np.uint32).copy()
    u[np.isnan(x)] = 0x7FC00000
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _radix_select2(keys, k1, k2):
    """The kernel's select: per round, a 256-bin histogram of the digit
    under the keys that match each rank's prefix so far (one histogram
    while the prefixes agree, two once they part), then the digit whose
    bin holds the rank, and the rank within that bin."""
    p1 = p2 = 0
    for shift in (24, 16, 8, 0):
        hi = 0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        digit = (keys >> shift) & 255
        m1 = (keys & hi) == p1
        m2 = ~m1 & ((keys & hi) == p2)
        h1 = np.bincount(digit[m1], minlength=256)
        h2 = np.bincount(digit[m2], minlength=256) if p1 != p2 else h1

        def pick(h, k):
            cum = np.cumsum(h)
            d = int(np.searchsorted(cum, k, side="right"))
            return d, k - (int(cum[d - 1]) if d else 0)
        (d1, k1), (d2, k2) = pick(h1, k1), pick(h2, k2)
        p1, p2 = p1 | d1 << shift, p2 | d2 << shift
    return p1, p2


def _edge_row(kind, n, rng):
    x = rng.random(n, dtype=np.float32) * 0.1 + 1.0
    if kind == "nan":
        x[::3] = np.nan
    elif kind == "sign_nan":
        x[::4] = SIGN_NAN
        x[1::5] = np.nan
    elif kind == "zeros":
        x[::2] = 0.0
        x[1::3] = -0.0
    elif kind == "inf":
        x[::5] = np.inf
        x[1::7] = -np.inf
    elif kind == "ties":
        x = np.round(x * 16) / 16
    elif kind == "equal":
        x[:] = 1.25
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "nan", "sign_nan", "zeros",
                                  "inf", "ties", "equal"])
@pytest.mark.parametrize("n", [1, 2, 3, 16383, 16384])
def test_radix_select_matches_partition(kind, n):
    x = _edge_row(kind, n, np.random.default_rng(n))
    h = n // 2
    k1 = h if n % 2 else h - 1
    p1, p2 = _radix_select2(_keys(x), k1, h)
    ordered = np.sort(_keys(x))
    assert (p1, p2) == (int(ordered[k1]), int(ordered[h]))   # bit for bit
    part = np.partition(x, [k1, h])
    for key, want in ((p1, part[k1]), (p2, part[h])):
        got = np.uint32(key ^ 0x80000000 if key & 0x80000000 else ~key
                        & 0xFFFFFFFF).view(np.float32)
        assert got == want or (np.isnan(got) and np.isnan(want))


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
                                   (1, 8, 16383), (3, 4, 130),
                                   (1, 8, 131072)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 16383, 16384, 131072])
def test_kernel_edge_rows_on_card(cuda, n):
    """Rows staged in shared memory and rows streamed from global memory
    (131,072 nodes), each metric another edge case."""
    rng = np.random.default_rng(n)
    kinds = ["random", "nan", "sign_nan", "zeros", "inf", "ties", "equal"]
    mats = np.stack([_edge_row(kd, n, rng) for kd in kinds])[None]
    t = torch.from_numpy(mats).to(cuda)
    kw = dict(z_threshold=3.0, slowdown_floor=0.025, mad_floor_frac=0.01)
    got = fleet_score(t, DIRS[:7], 0, **kw)
    want = plain(t, DIRS[:7], 0, **kw)
    _assert_same(tuple(x.cpu().numpy() for x in want),
                 tuple(x.cpu().numpy() for x in got))
