"""The row chase over ``cuda_probes.cycle_table``, the table the caches
cannot hold: the table itself, and ``cuda_probes.row_chase`` on CPU tensors
(which runs its plain version, under either feed) against the JAX package's
TPU probes run in interpret mode, ``tools/prof_visits.py::dma_chase`` and
``tools/prof_dma_chains.py::chase``, and against a numpy walk of the cycle.

On a cycle table every hop copies a new row until the cycle wraps, so after
2 x rows hops each chain has been round its cycle twice.  Everything is
compared exactly: refs are integers held exactly in float32.  The CUDA
kernel's two feeds are held against the plain version on the card by
``chip_smoke.py``'s probes phase.

The TPU probes come from ``test_torch_probes_counts.py``'s module fixture
``tpu_probes`` (``pallas_call`` in interpret mode; ``chase`` compiled alone
from its file's source).  Interpreted DMAs are slow: a test interprets at
most 512 hops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplepath_tpu_torch.render import cuda_probes as cp
from simplepath_tpu_torch.scene import bvh
from test_torch_probes_counts import tpu_probes  # noqa: F401  (a module fixture)

torch.set_num_threads(1)

SLOT = 6 * bvh.WIDTH
SIZES = (64, 256)


def _walk(table: np.ndarray, start: int, hops: int) -> list:
    """The chase written out with numpy: the row copied at each hop, then
    the last ref (slot 6W of the copy where positive, else the start)."""
    ref, rows = np.float32(start), []
    for _ in range(hops):
        row = min(max(int(abs(ref)) - 1, 0), table.shape[0] - bvh.LEAF_ROWS)
        rows.append(row)
        child = table[row, SLOT]
        ref = child if child > 0 else np.float32(start)
    return rows + [float(ref)]


@pytest.mark.parametrize("rows", SIZES + (1000,))
def test_cycle_table_is_one_cycle(rows):
    """Slot 6W holds exact integer refs that make one cycle over rows
    0 .. rows - LEAF_ROWS: a lap from any row visits each of them once and
    comes back; every other value is 0."""
    table = cp.cycle_table(rows, device="cpu")
    assert table.shape == (rows, bvh.RECORD_WIDTH) and table.dtype == torch.float32
    n = rows - bvh.LEAF_ROWS + 1
    refs = table[:n, SLOT].numpy()
    assert np.array_equal(refs, np.round(refs))
    assert refs.min() == 1 and refs.max() == n
    assert sorted(refs.astype(np.int64)) == list(range(1, n + 1))
    rest = table.clone()
    rest[:n, SLOT] = 0.0
    assert not bool(rest.any())
    lap = _walk(table.numpy(), 1, n)
    assert sorted(lap[:n]) == list(range(n)) and lap[n] == 1.0


def test_cycle_table_is_the_same_for_the_same_seed():
    a, b = cp.cycle_table(256, seed=3, device="cpu"), cp.cycle_table(256, seed=3, device="cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, cp.cycle_table(256, seed=4, device="cpu"))
    assert not torch.equal(a, cp.cycle_table(256, device="cpu"))


@pytest.mark.parametrize("rows", [0, 2 ** 24 + 1])
def test_cycle_table_raises_outside_exact_refs(rows):
    """Above 2**24 rows a ref would not be an exact float32 integer (the
    check comes before any allocation)."""
    with pytest.raises(ValueError):
        cp.cycle_table(rows, device="cpu")


def test_cycle_table_defaults_to_cuda():
    if torch.cuda.is_available():
        assert cp.cycle_table(64).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            cp.cycle_table(64)


def _hops(rows: int, lap: str) -> int:
    """Twice round the cycle, or a count that ends mid-lap."""
    return 2 * rows if lap == "two_laps" else rows + rows // 3


@pytest.mark.parametrize("lap", ["two_laps", "mid_lap"])
@pytest.mark.parametrize("rows", SIZES)
def test_chase_equals_dma_chase(tpu_probes, rows, lap):
    prof_visits, _, _ = tpu_probes
    table = cp.cycle_table(rows, seed=rows, device="cpu")
    hops = _hops(rows, lap)
    ref = float(np.asarray(prof_visits.dma_chase(jnp.asarray(table.numpy()),
                                                 hops))[0, 0])
    out = cp.row_chase(table, 1, hops)
    assert out.dtype == torch.float32 and out.shape == (1,)
    assert float(out[0]) == ref == _walk(table.numpy(), 1, hops)[-1]


@pytest.mark.parametrize("lap", ["two_laps", "mid_lap"])
@pytest.mark.parametrize("rows", SIZES)
def test_chase_of_four_chains_equals_chase(tpu_probes, rows, lap):
    """prof_dma_chains.chase interleaves four chains and writes chain 0's
    ref."""
    _, _, chase = tpu_probes
    table = cp.cycle_table(rows, seed=rows, device="cpu")
    hops = _hops(rows, lap)
    ref = float(np.asarray(chase(jnp.asarray(table.numpy()), hops, 4))[0, 0])
    assert float(cp.row_chase(table, 4, hops)[0]) == ref


@pytest.mark.parametrize("chains", cp.CHAINS)
@pytest.mark.parametrize("rows", SIZES)
def test_chase_equals_the_walk_of_the_cycle(rows, chains):
    """Every chain's refs, and the row each chain copies at each hop, are
    the numpy walk's, at 2 x rows hops and at a count that ends mid-lap."""
    table = cp.cycle_table(rows, seed=rows, device="cpu")
    for hops in (_hops(rows, "two_laps"), _hops(rows, "mid_lap")):
        walks = [_walk(table.numpy(), 1 + c, hops) for c in range(chains)]
        refs, visited = cp.row_chase_plain(table, chains, hops, visited=True)
        assert refs.tolist() == [w[-1] for w in walks]
        assert visited.T.tolist() == [w[:-1] for w in walks]
        assert cp.row_chase(table, chains, hops).tolist() == refs.tolist()
    # twice round the cycle: each chain copies every row twice
    n = rows - bvh.LEAF_ROWS + 1
    _, visited = cp.row_chase_plain(table, chains, 2 * n, visited=True)
    for c in range(chains):
        assert np.bincount(visited[:, c].numpy(), minlength=n).tolist() == [2] * n


@pytest.mark.parametrize("feed", cp.FEEDS)
@pytest.mark.parametrize("rows", SIZES)
def test_both_feeds_give_the_plain_refs_on_the_cpu(rows, feed):
    table = cp.cycle_table(rows, seed=rows, device="cpu")
    cp.reset_launch_counts()
    for chains in cp.CHAINS:
        assert torch.equal(cp.row_chase(table, chains, 2 * rows, feed=feed),
                           cp.row_chase_plain(table, chains, 2 * rows))
    assert cp.launch_counts["row_chase"] == 0


@pytest.mark.parametrize("feed", ["tma", "LDG", "", None])
def test_an_unknown_feed_raises(feed):
    table = cp.cycle_table(64, device="cpu")
    with pytest.raises(ValueError):
        cp.row_chase(table, 1, 4, feed=feed)


def test_the_feeds_are_the_sources():
    """FEEDS is csrc/traverse.cu's ChaseFeed, in its numbering."""
    import re
    from simplepath_tpu_torch.render import cuda_traverse as ct
    with open(ct.KERNEL_SOURCE) as f:
        source = f.read()
    body = re.search(r"enum ChaseFeed \{([^}]*)\}", source).group(1)
    numbered = {int(v): name for name, v in re.findall(r"FEED_(\w+)\s*=\s*(\d+)", body)}
    assert tuple(numbered[i].lower() for i in sorted(numbered)) == cp.FEEDS
