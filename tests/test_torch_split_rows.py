"""Rows held by their owners, in one process and without JAX: the owner
helper (``sharding.RowOwners``), the client arena split over two ranks
(``ClientArena.place``) and the serving bank placed over two ranks
(``ClusterBank.place`` / ``placed``).

The two ranks are two threads over a fake mesh (``FakeMesh``: one client
axis of two, the rank's coordinate, the CPU) whose ``all_reduce`` sums
the two threads' tensors at a barrier, so every collective runs as it
does across processes. Each case runs the same calls on both ranks, as
the engine does.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.arena import ClientArena  # noqa: E402
from repro_torch.engine.bank import ClusterBank, RemoteRowError  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402


class FakeMesh:
    """A one-axis client mesh of ``size`` ranks seen from ``rank``."""
    mesh_dim_names = ("clients",)
    device_type = "cpu"

    def __init__(self, rank, size=2):
        self.rank, self.shape = rank, (size,)

    def get_coordinate(self):
        return [self.rank]


class FakeWorld:
    """``all_reduce_`` over two threads: each call waits for the other
    rank's tensor and both get the sum."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=20)
        self.slots = [None, None]

    def all_reduce_(self, t, mesh):
        self.slots[mesh.rank] = t.clone()
        self.barrier.wait()
        total = self.slots[0] + self.slots[1]
        self.barrier.wait()
        return t.copy_(total)


def on_two_ranks(fn, monkeypatch):
    """``fn(mesh)`` on rank 0 and rank 1 at once: their results."""
    world = FakeWorld()
    monkeypatch.setattr(specs, "all_reduce_", world.all_reduce_)
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(fn, FakeMesh(r)) for r in (0, 1)]
        return [f.result(timeout=60) for f in futs]


def same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def stack(n, seed=0):
    """``n`` rows of leaves of four dtypes, with -0.0, NaN and int64
    extremes among them."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, 3, 2)).astype(np.float32))
    x[1 % n, 0, 0], x[2 % n, 1, 1] = -0.0, float("nan")
    ints = torch.as_tensor(rng.integers(-9, 9, size=(n, 4)))
    ints[0, 0], ints[n - 1, 3] = torch.iinfo(torch.int64).min, torch.iinfo(torch.int64).max
    return {"x": x, "i": ints, "b": torch.as_tensor(rng.random((n, 5)) > 0.5),
            "h": torch.as_tensor(rng.normal(size=(n, 2))).to(torch.bfloat16)}


# ------------------------------------------------------------ the owners
@pytest.mark.parametrize("rank", (0, 1))
def test_owners_are_a_stride(rank):
    own = specs.row_owners(8, FakeMesh(rank))
    assert own.sharded and (own.rank, own.size) == (rank, 2)
    assert own.held(8) == 4 and own.held(16) == 8
    assert [own.owner(r) for r in range(6)] == [0, 1, 0, 1, 0, 1]
    assert [own.local(r) for r in range(6)] == [0, 0, 1, 1, 2, 2]
    assert [r for r in range(8) if own.mine(r)] == list(range(rank, 8, 2))
    rows = torch.arange(8)[:, None]
    assert torch.equal(own.take(rows)[:, 0], torch.arange(rank, 8, 2))


def test_owners_relax_where_rows_do_not_divide():
    for own in (specs.row_owners(7, FakeMesh(1)), specs.row_owners(8, FakeMesh(0, 1)),
                specs.row_owners(8, None)):
        assert not own.sharded and own.held(7) == 7 and own.mine(5) and own.local(5) == 5
    x = torch.arange(7)
    assert specs.row_owners(7, FakeMesh(1)).take(x) is x


def test_gather_is_the_rows_bit_for_bit(monkeypatch):
    full = stack(8)
    rows = torch.tensor([5, 0, 3, 3, 7, 2, 6, 1, 4])

    def run(mesh):
        own = specs.row_owners(8, mesh)
        return own.gather(own.take(full), rows)

    for got in on_two_ranks(run, monkeypatch):
        for k, x in full.items():
            assert same_bits(got[k], x[rows]), k


def test_send_is_the_owner_tensor_on_every_rank(monkeypatch):
    want = stack(2)["x"][1]

    def run(mesh):
        own = specs.row_owners(4, mesh)
        return own.send(want if mesh.rank == 1 else None, 1, want)

    for got in on_two_ranks(run, monkeypatch):
        assert same_bits(got, want)


# ------------------------------------------------------------- the arena
def clients(n, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    return [{"x": torch.as_tensor(rng.normal(size=(6 - (i % 3 if ragged else 0), 3))
                                  .astype(np.float32)),
             "y": torch.as_tensor(rng.integers(0, 9, size=6 - (i % 3 if ragged else 0)))}
            for i in range(n)]


def churn(arena, extra):
    """Three joins past the capacity (6 -> 12 rows), a rewrite, then
    departures past ``compact_frac``: the arena after each step."""
    steps = [arena]
    for b in extra[:3]:
        arena = arena.append(b)
    steps.append(arena)
    arena = arena.update(4, extra[3])
    steps.append(arena)
    for cid in (0, 1, 2, 5, 6):
        arena = arena.tombstone(cid)
    steps.append(arena)
    return steps


def held_rows(arena):
    """``{global row: (packed leaves, mask)}`` of the rows a rank holds."""
    own = arena.owners
    return {own.rank + own.size * j: ({k: v[j] for k, v in arena.packed.items()},
                                      arena.mask[j]) for j in range(arena.held)}


def test_split_arena_keeps_its_rows_through_growth_and_compaction(monkeypatch):
    base, extra = clients(6), clients(4, seed=1)
    plain = churn(ClientArena.from_clients(base), extra)

    def run(mesh):
        steps = churn(ClientArena.from_clients(base).place(mesh), extra)
        live = [[int(c) for c in a._live()] for a in steps]
        return steps, [a.gather(ids) for a, ids in zip(steps, live)], live

    assert plain[-1].n_rows == 4 and plain[-1].capacity == 4     # compacted
    ranks = on_two_ranks(run, monkeypatch)
    for r, (steps, gathered, live) in enumerate(ranks):
        for a, p, got, ids in zip(steps, plain, gathered, live):
            assert a.owners.sharded and a.owners.rank == r
            assert a.capacity == 2 * a.held and a.capacity >= p.capacity
            assert a.held == a.mask.shape[0] and (a.rows == p.rows).all()
            want = p.gather(ids)
            assert set(got) == set(want)
            for k in want:
                assert same_bits(got[k], want[k]), k
            for row, (leaves, mask) in held_rows(a).items():
                assert row % 2 == r
                if row < p.capacity:
                    assert torch.equal(mask, p.mask[row])
                    for k, v in leaves.items():
                        assert same_bits(v, p.packed[k][row]), (row, k)
                else:
                    assert not mask.any()
    # the ranks' rows, together: every row of the arena without a split
    for turn, p in enumerate(plain):
        rows = {**held_rows(ranks[0][0][turn]), **held_rows(ranks[1][0][turn])}
        assert sorted(rows)[:p.capacity] == list(range(p.capacity))
    assert ranks[0][0][1].capacity == 12 and ranks[0][0][-1].capacity == 4


def test_split_arena_client_is_the_owner_view(monkeypatch):
    def run(mesh):
        a = ClientArena.from_clients(clients(4, ragged=False)).place(mesh)
        out = {}
        for cid in range(4):
            try:
                out[cid] = a.client(cid)["x"]
            except LookupError as err:
                out[cid] = str(err)
        return out, a.nbytes

    base = clients(4, ragged=False)
    for r, (out, nbytes) in enumerate(on_two_ranks(run, monkeypatch)):
        assert nbytes == 2 * 6 * (3 * 4 + 8)           # two rows of x and y
        for cid, got in out.items():
            if cid % 2 == r:
                assert torch.equal(got, base[cid]["x"])
            else:
                assert f"held by rank {cid % 2}" in got


# -------------------------------------------------------------- the bank
def models(roots, seed=0):
    return {r: {k: v[0] for k, v in stack(1, seed + i).items() if k in ("x", "i")}
            for i, r in enumerate(roots)}


@pytest.mark.parametrize("rank", (0, 1))
def test_placed_bank_holds_its_rows(rank):
    ms = models([3, 8, 11, 20])
    whole = ClusterBank.from_dict(ms)
    mesh = FakeMesh(rank)
    placed = whole.place(mesh)
    mine, theirs = [3, 8, 11, 20][2 * rank:2 * rank + 2], [3, 8, 11, 20][2 - 2 * rank:4 - 2 * rank]
    assert placed.roots == (3, 8, 11, 20) and placed.capacity == 2
    assert placed.place(mesh) is placed
    # views of the whole bank's rows: no copy
    assert placed.stacked["x"].data_ptr() == whole.stacked["x"][2 * rank].data_ptr()
    for r in mine:
        assert placed.holds(r) and same_bits(placed[r]["x"], ms[r]["x"])
        assert same_bits(placed[r]["i"], ms[r]["i"])
    for r in theirs:
        assert not placed.holds(r) and r in placed
        with pytest.raises(RemoteRowError, match=f"rank {1 - rank} "):
            placed[r]
        with pytest.raises(RemoteRowError):
            placed.get(r, "default")
    assert placed.get(99, "default") == "default" and placed.holds(99)
    built = ClusterBank.placed({r: ms[r] for r in mine}, list(ms), mesh)
    for r in mine:
        assert same_bits(built[r]["x"], placed[r]["x"])
    for what in (lambda b: b.put([3], whole.take([3], ms[3])), lambda b: b.take([3], ms[3]),
                 lambda b: b.drop([3]), lambda b: b.rename({3: 4})):
        with pytest.raises(RuntimeError, match="placed"):
            what(placed)


def test_bank_out_of_order_is_placed_in_order():
    ms = models([20, 3, 11, 8])
    bank = ClusterBank.empty()
    for r in (20, 3, 11, 8):
        bank = bank.set(r, ms[r])
    assert bank.roots == (20, 3, 11, 8)
    for rank in (0, 1):
        placed = bank.place(FakeMesh(rank))
        assert placed.roots == (3, 8, 11, 20)
        for r in (3, 8, 11, 20)[2 * rank:2 * rank + 2]:
            assert same_bits(placed[r]["x"], ms[r]["x"])


def test_bank_relaxes_where_groups_do_not_divide():
    ms = models([1, 2, 3])
    whole = ClusterBank.from_dict(ms)
    assert whole.place(FakeMesh(1)) is whole and whole.place(None) is whole
    built = ClusterBank.placed(ms, [1, 2, 3], FakeMesh(1))
    assert built.split is None and built.roots == whole.roots
    for r in ms:
        assert same_bits(built[r]["x"], whole[r]["x"])     # NaN among them
    assert ClusterBank.placed({}, [], FakeMesh(0)) == ClusterBank.empty()
