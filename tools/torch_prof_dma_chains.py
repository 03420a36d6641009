#!/usr/bin/env python3
"""How long a dependent row copy takes at each level of the card's memory,
and how many one warp keeps in flight: the port's counterpart of
tools/prof_dma_chains.py.

    python3 tools/torch_prof_dma_chains.py            # 20,000 hops, four tables

sp_row_chase runs C = 1, 2, 4, 8 independent pointer chases in one warp,
each hop a copy of one row (LEAF_ROWS x 512 B) into shared memory, every
chain's copy of a hop issued before any is waited on.  Two feeds of the same
function, timed in turns (bulk, ldg, ldg, bulk; the least of each):

  bulk  a TMA bulk copy that completes on an mbarrier, the card's
        counterpart of the TPU probe's row DMA on a DMA semaphore; it goes
        through L2 and skips L1;
  ldg   the traversal's own feed: the lanes' loads through L1.

Four tables set which level serves a hop:

  bench           the bench scene's records (16.4 MB): slot 6W is an
                  internal row's first child, so the chase cycles over the
                  left spine's few rows, which stay in L1 (a cached row);
  cycle_4096      cuda_probes.cycle_table(4_096), 2 MiB: every hop a new row
                  until the cycle wraps, past L1, inside the 50 MB L2;
  cycle_262144    128 MiB, past L2: device memory (HBM), what the TPU probe
                  reads ("per-visit DMA latency floor (HBM->SMEM)");
  cycle_2097152   1 GiB: HBM over a span like lucy's 1.55 GB table, with the
                  TLB misses its rows pay.

On the tables past L2 each timed launch follows a zeroing of a 256 MiB
buffer, so no row of the last launch is cached; the others run warm.
If C chains take as long as one, the copies overlap; if the time grows with
C, they serialise.  Printed for each (table, feed, C): ns a hop and a hop a
chain, the distinct rows copied, the refs (held exactly against the plain
version's: one plain run at C=8 a table, its first C refs) and the bound
(the distinct rows' bytes over 3.35 TB/s); for each table the SM clock
while a chase runs (nvidia-smi clocks.sm), so that ns read as cycles.  First
the card line, ptxas's registers, shared memory and spills of each kernel
instance, and the opcodes of each in the library's machine code (a TMA
bulk copy is UBLKCP, the mbarrier operations SYNCS.*).  Every reading also
goes to chip_smoke_out/dma_chains/readings.json.  Needs one CUDA device;
imports nothing of JAX; exits 1 on a mismatch, a spill or machine code that
is not the feed's.
"""

import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TABLES = {"bench": None, "cycle_4096": 4_096, "cycle_262144": 262_144,
          "cycle_2097152": 2_097_152}
L2_BYTES = 50 << 20
FLUSH_BYTES = 256 << 20
OUT = os.path.join(ROOT, "chip_smoke_out", "dma_chains")
CLOCK_WINDOW_MS = 1_000.0   # chases queued while nvidia-smi reads the clock


# opcodes that feed a row in sp_row_chase's machine code: the TMA bulk copy,
# the mbarrier operations (SYNCS.*), global loads and stores, shared ones
CHASE_OPCODES = ("UBLKCP", "SYNCS", "LDG", "LDGSTS", "STG", "LDS", "STS")


def chase_sass(library: str) -> dict:
    """Each ``row_chase_kernel<C,feed>`` instance of the library, its
    CHASE_OPCODES counted in its machine code (``cuobjdump -sass``); raises
    unless every bulk instance (feed 0) has a bulk copy and mbarrier
    operations and no global load, and every ldg instance (feed 1) global
    loads and no bulk copy."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    from simplepath_tpu_torch.render import cuda_traverse as ct
    tool = os.path.join(os.path.dirname(ct._nvcc()), "cuobjdump")
    sass = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                           "-sass", library], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = cs.kernel_name(m.group(1))
            if name.startswith("row_chase_kernel<"):
                out[name] = dict.fromkeys(CHASE_OPCODES, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and name in out and m.group(1) in CHASE_OPCODES:
            out[name][m.group(1)] += 1
    bulk, ldg = cp.FEEDS.index("bulk"), cp.FEEDS.index("ldg")
    for chains in cp.CHAINS:
        b = out.get(f"row_chase_kernel<{chains},{bulk}>")
        g = out.get(f"row_chase_kernel<{chains},{ldg}>")
        if (b is None or g is None or not b["UBLKCP"] or not b["SYNCS"]
                or b["LDG"] or b["LDGSTS"] or not g["LDG"] or g["UBLKCP"]):
            raise AssertionError(f"sp_row_chase's machine code at {chains} "
                                 f"chains: bulk {b}, ldg {g}")
    return out


def sm_clock_while(fn, ms: float) -> str:
    """nvidia-smi's clocks.sm, read while launches of ``fn`` (``ms`` each)
    keep the card busy for about CLOCK_WINDOW_MS."""
    for _ in range(max(1, int(CLOCK_WINDOW_MS / max(ms, 1e-3)))):
        fn()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    torch.cuda.synchronize()
    return clock.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.render import cuda_probes as cp
    from simplepath_tpu_torch.render import cuda_traverse as ct

    os.makedirs(OUT, exist_ok=True)
    card = cs.nvidia_smi_line()
    print(f"card: {card}", flush=True)
    ptxas = cs.ptxas_summary(ct._compile_source(
        ct.KERNEL_SOURCE, ct.library_path(), verbose=True).splitlines())
    chase_ptxas = {k: v for k, v in ptxas.items() if k.startswith("row_chase_kernel<")}
    sass = chase_sass(ct.library_path())
    ct._library()
    for name in sorted(chase_ptxas):
        print(f"{name} ({cp.FEEDS[int(name[-2])]}): ptxas {chase_ptxas[name]}; "
              f"sass {sass[name]}", flush=True)
    results = {"card": card, "hops": cs.PROBE_HOPS, "ptxas": chase_ptxas,
               "sass": sass, "tables": {}}
    ok = not any(v.get("spill_stores") or v.get("spill_loads")
                 for v in chase_ptxas.values())

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for name, rows in TABLES.items():
        t0 = time.time()
        table = (sp.load_scene(cs.SCENE).bvh.records if rows is None
                 else cp.cycle_table(rows))
        torch.cuda.synchronize()
        cold = table.numel() * 4 > L2_BYTES
        print(f"{name}: {table.shape[0]} rows, {table.numel() * 4} B, "
              f"{'cold (flushed before each launch)' if cold else 'warm'}, "
              f"made in {time.time() - t0:.1f} s", flush=True)
        try:
            readings = cs.chase_readings(table, name, cs.PROBE_HOPS,
                                         cp.FEEDS + cp.FEEDS[::-1],
                                         flush if cold else None)
        except AssertionError as e:
            print(f"MISMATCH: {e}", flush=True)
            ok = False
            continue
        one = next(r for r in readings if r["chains"] == 1 and r["feed"] == "bulk")
        clock = sm_clock_while(lambda: cp.row_chase(table, 1, cs.PROBE_HOPS),
                               one["kernel_ms"])
        for r in readings:
            print(f"  {r['feed']:4s} C={r['chains']}: {r['kernel_ms']:.4f} ms "
                  f"(turns {['%.4f' % t for t in r['kernel_ms_turns']]}), "
                  f"{r['ns_per_hop']:.1f} ns/hop, {r['ns_per_hop_per_chain']:.1f} "
                  f"ns/hop a chain, {r['distinct_rows']} distinct rows, bound "
                  f"{r['bound_ms']:.3g} ms ({r['bound_by']}), refs {r['refs']} "
                  "equal to the plain version's", flush=True)
        print(f"  SM clock while a chase runs: {clock}", flush=True)
        results["tables"][name] = {"sm_clock": clock, "readings": readings}
        del table
        torch.cuda.empty_cache()
    with open(os.path.join(OUT, "readings.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
