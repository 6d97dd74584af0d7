"""The port's ``core.aggregators.byzantine_distance_screen`` against the
JAX package's on the CPU: Ψ rows made with numpy around a few cluster
means, outliers among them. The keep mask (a bool tensor on the rows'
device) equals the reference's at every τ whose distance from each
row's largest cosine (in float64) is at least 1e-5, the cosines' float32
rounding being ~1e-7; the means may be a tensor or a host array."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregators as jagg  # noqa: E402
from repro_torch.core import aggregators  # noqa: E402

GAP = 1e-5
N, K, D = 96, 5, 257


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    means = rng.standard_normal((K, D)).astype(np.float32)
    member = rng.integers(0, K, N)
    noise = rng.uniform(0.2, 3.0, (N, 1))
    reps = (means[member] + noise * rng.standard_normal((N, D))).astype(np.float32)
    reps[:8] = rng.standard_normal((8, D)).astype(np.float32) * 5      # no cluster's
    r64, m64 = reps.astype(np.float64), means.astype(np.float64)
    best = np.max((r64 / np.linalg.norm(r64, axis=1, keepdims=True))
                  @ (m64 / np.linalg.norm(m64, axis=1, keepdims=True)).T, axis=1)
    return reps, means, np.sort(best)


def _taus(best):
    """τ at 0, and midway between neighbouring largest cosines at five
    quantiles, each at least ``GAP`` from every row's."""
    picks = [0.0]
    for q in (0.1, 0.3, 0.5, 0.7, 0.9):
        i = int(q * (len(best) - 1))
        while best[i + 1] - best[i] < 2 * GAP:
            i += 1
        picks.append(float((best[i] + best[i + 1]) / 2))
    return picks


@pytest.mark.parametrize("which", range(6))
@pytest.mark.parametrize("means_as", ["tensor", "numpy"])
def test_keep_mask_matches_the_reference(data, which, means_as):
    reps, means, best = data
    tau = _taus(best)[which]
    assert np.min(np.abs(best - tau)) >= GAP
    want = jagg.byzantine_distance_screen(reps, tau)(means)
    screen = aggregators.byzantine_distance_screen(torch.as_tensor(reps), tau)
    got = screen(torch.as_tensor(means) if means_as == "tensor" else means)
    assert got.dtype == torch.bool and got.shape == (N,) and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(want))
    if which:                           # a τ inside the spread keeps some and drops some
        assert 0 < int(got.sum()) < N
