#!/usr/bin/env python3
"""What one visit body costs on the GPU, with the row in shared memory, in
both layouts of sp_visit_body: the port's counterpart of
tools/prof_visit_vpu.py.

    python3 tools/torch_prof_visit_vpu.py     # M=100000 bodies a case
    SIMPLEPATH_BVH_WIDTH=16 python3 tools/torch_prof_visit_vpu.py   # W=16

sp_visit_body runs M back-to-back visit bodies for the TPU probe's fixed ray
on rows 0 and 1 of the bench's table (which the ray misses) and on a table
whose rows it crosses (render/cuda_probes.py::crossed_table), in four modes:
``internal`` (the slab tests, the placement far to near and the push),
``internal_norel`` (the slab tests alone), ``sort_only`` (the placement
alone) and ``leaf`` (the K triangle tests and their first minimum); and in
two layouts of the same function: ``lane`` (the default: one thread a ray,
the row broadcast from shared memory, the Batcher network in registers) and
``group`` (the traversal's visit, W lanes a ray).  Three launch shapes:
one warp (its ns a body is the latency of one body), one full wave at the
layout's own occupancy (ns a ray-body card-wide: the throughput) and one
with as many warps an SM as sp_closest.  Every case is first held against
the plain version in both layouts (chip_smoke.check_visit_body; the two
tied crossed tables are only checked), then the layouts are timed in turns
(lane, group, group, lane; the least of each).

Printed first: the card, ptxas's registers and spills of each
visit_body_kernel<layout,mode,check> instance, and the machine code of each
timed instance's body loop (cuobjdump -sass) counted by class: FADD/FMUL,
FMNMX, FSETP/FSEL/SEL, LDS, STS, SHFL/VOTE (the lane layout has none); then
a line a case and layout: ms, ns a body, ps a ray-body, the share of the
operation bound (bodies x rays x chip_smoke.body_ops over the float32 peak)
beside the BODY_ISSUE_CEILING that -fmad=false leaves, blocks an SM, and
the share of the SMs' lane-issue slots the loop's instructions fill at the
SM clock read while the bodies run.  Every reading also goes to
chip_smoke_out/visit_vpu/readings.json.  Needs one CUDA device; imports
nothing of JAX; exits 1 on a mismatch, a spill, or a shuffle or vote in
the lane layout's loop.
"""

import heapq
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from torch_prof_dma_chains import sm_clock_while  # noqa: E402

OUT = os.path.join(ROOT, "chip_smoke_out", "visit_vpu")
TIMED_TABLES = ("bench", "crossed")
# opcode classes of a body loop's machine code
CLASSES = {"fadd_fmul": ("FADD", "FMUL"), "ffma": ("FFMA",),
           "fmnmx": ("FMNMX",), "fsetp_sel": ("FSETP", "FSEL", "SEL"),
           "lds": ("LDS",), "sts": ("STS",),
           "shfl_vote": ("SHFL", "VOTE", "VOTEU")}
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)(\S*)\s*([^;]*);")
# instructions that end a basic block
BLOCK_ENDS = ("BRA", "EXIT", "RET", "BRX", "JMX", "JMP")


def _blocks(ins: list) -> tuple:
    """The basic blocks of one function's machine code (``ins``: (address,
    predicate, opcode, suffix, operands) in address order) and each block's
    successors: a branch's target, and the next block where the branch is
    predicated or taken only on divergence (BRA.DIV)."""
    index = {i[0]: k for k, i in enumerate(ins)}
    target = lambda i: re.search(r"0x([0-9a-f]+)", i[4])
    leaders = {0}
    for k, i in enumerate(ins):
        if i[2] in BLOCK_ENDS:
            leaders.add(k + 1)
            if i[2] == "BRA" and target(i):
                leaders.add(index[int(target(i).group(1), 16)])
    starts = sorted(x for x in leaders if x < len(ins))
    blocks = [ins[a:b] for a, b in zip(starts, starts[1:] + [len(ins)])]
    first = {blk[0][0]: n for n, blk in enumerate(blocks)}
    succ = []
    for n, blk in enumerate(blocks):
        last, nxt = blk[-1], [n + 1] if n + 1 < len(blocks) else []
        if last[2] == "BRA":
            to = [first[int(target(last).group(1), 16)]] if target(last) else []
            succ.append(to + (nxt if last[1] or last[3] == ".DIV" else []))
        elif last[2] in BLOCK_ENDS:
            succ.append(nxt if last[1] else [])
        else:
            succ.append(nxt)
    return blocks, succ


def _shortest_cycle(blocks: list, succ: list, start: int) -> list:
    """The instructions of the shortest cycle (in instructions) from block
    ``start`` back to it, or []."""
    dist, prev = {start: len(blocks[start])}, {}
    heap, best = [(len(blocks[start]), start)], None
    while heap:
        d, n = heapq.heappop(heap)
        if d > dist.get(n, 1 << 30):
            continue
        for m in succ[n]:
            if m == start:
                if best is None or d < best[0]:
                    best = (d, n)
            elif d + len(blocks[m]) < dist.get(m, 1 << 30):
                dist[m] = d + len(blocks[m])
                prev[m] = n
                heapq.heappush(heap, (dist[m], m))
    if best is None:
        return []
    path, n = [], best[1]
    while n != start:
        path.append(n)
        n = prev[n]
    return [i for n in [start] + path[::-1] for i in blocks[n]]


def body_cycle(ins: list) -> tuple:
    """A visit-body kernel's bodies loop: the shortest cycle of its control
    flow through a block that loads the zero (a 32-bit LDS at the offset to
    which thread 0 first stores RZ), i.e. the path of a body on which no
    rare branch is taken (the group layout's network on tied keys, a
    divergent shuffle, a division's slow path); → (its instructions, the
    loads of the zero on it: the bodies a pass, where the compiler
    unrolled the loop)."""
    store = next((i[4] for i in ins if i[2] == "STS" and not i[3]
                  and i[4].rstrip().endswith("RZ")), None)
    if store is None:
        return [], 0
    off = re.search(r"(\+0x[0-9a-f]+)?\]", store).group(1) or ""
    zero = lambda i: (i[2] == "LDS" and not i[3] and re.search(
        re.escape(off) + r"\]\s*$", i[4]) is not None)
    blocks, succ = _blocks(ins)
    for start, blk in enumerate(blocks):
        if any(zero(i) for i in blk):
            cycle = _shortest_cycle(blocks, succ, start)
            if cycle:
                return cycle, sum(1 for i in cycle if zero(i))
    return [], 0


def body_loops(library: str) -> dict:
    """Each timed ``visit_body_kernel<layout,mode,0>`` instance of the
    library: a body's instructions in its machine code (body_cycle: the
    cycle over the bodies it holds), by CLASSES and by opcode."""
    from simplepath_tpu_torch.render import cuda_traverse as ct
    tool = os.path.join(os.path.dirname(ct._nvcc()), "cuobjdump")
    sass = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                           "-sass", library], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    code, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = cs.kernel_name(m.group(1))
            if name.startswith("visit_body_kernel<") and name.endswith(",0>"):
                code[name] = []
            continue
        m = SASS_LINE.search(line)
        if m and name in code:
            code[name].append((int(m.group(1), 16), (m.group(2) or "").strip(),
                               m.group(3), m.group(4), m.group(5)))
    out = {}
    for name, ins in code.items():
        cycle, bodies = body_cycle(ins)
        ops = {}
        for i in cycle:
            ops[i[2]] = ops.get(i[2], 0) + 1
        per = max(bodies, 1)
        out[name] = {"bodies_a_pass": bodies, "instructions": len(cycle) / per,
                     **{c: sum(ops.get(o, 0) for o in opcodes) / per
                        for c, opcodes in CLASSES.items()},
                     "opcodes": dict(sorted(ops.items()))}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.render import cuda_probes as cp
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.scene.bvh import LEAF_SIZE, WIDTH

    os.makedirs(OUT, exist_ok=True)
    card = cs.nvidia_smi_line()
    print(f"card: {card}; W={WIDTH} K={LEAF_SIZE}", flush=True)
    lib = ct.library_path()
    ptxas = {k: v for k, v in cs.ptxas_summary(ct._compile_source(
        ct.KERNEL_SOURCE, lib, verbose=True).splitlines()).items()
        if k.startswith("visit_body_kernel<")}
    sass = body_loops(lib)
    ct._library()
    ok = True
    for name in sorted(ptxas):
        layout = cp.BODY_LAYOUTS[int(name.split("<")[1].split(",")[0])]
        loop = sass.get(name)
        print(f"{name} ({layout}): ptxas {ptxas[name]}"
              + (f"; body loop {({k: v for k, v in loop.items() if k != 'opcodes'})}"
                 if loop else ""), flush=True)
        if ptxas[name].get("spill_stores") or ptxas[name].get("spill_loads"):
            ok = False
        if loop is not None and layout == "lane" and (
                loop["shfl_vote"] or not loop["instructions"]):
            ok = False
    if not ok:
        print("a visit-body kernel spills, or the lane layout's loop is "
              "missing or shuffles", flush=True)

    bodies = cs.PROBE_BODIES
    records = sp.load_scene(cs.SCENE).bvh.records
    sms = torch.cuda.get_device_properties(records.device).multi_processor_count
    clock = None
    readings = []
    for table, (rec, seed) in cs.body_tables(records).items():
        for mode in cp.BODY_MODES:
            shapes = {layout: cs.body_shapes(mode, layout, records.device)
                      for layout in cp.BODY_LAYOUTS}
            for shape in shapes["lane"][1]:
                turns = {layout: [] for layout in cp.BODY_LAYOUTS}
                try:
                    for layout, (_, by_shape) in shapes.items():
                        cs.check_visit_body(rec, seed, mode, by_shape[shape],
                                            table, layout)
                except AssertionError as e:
                    print(f"MISMATCH: {e}", flush=True)
                    ok = False
                    continue
                if table not in TIMED_TABLES:
                    continue
                for layout in cp.BODY_LAYOUTS + cp.BODY_LAYOUTS[::-1]:
                    turns[layout].append(cs.body_times(
                        rec, seed, mode, shapes[layout][1][shape], layout,
                        bodies))
                if clock is None:       # read once, on the first timed case
                    lane_n = shapes["lane"][1][shape]
                    clock = sm_clock_while(
                        lambda: cp.visit_body(rec, seed, mode, bodies, lane_n),
                        turns["lane"][0]["kernel_ms"])
                mhz = float(clock.split()[0])
                for layout, runs in turns.items():
                    best = min(runs, key=lambda r: r["kernel_ms"])
                    blocks, by_shape = shapes[layout]
                    threads = cp.BODY_BLOCK // cp.body_rays_per_block(layout)
                    loop = sass.get(f"visit_body_kernel<{cp.BODY_LAYOUTS.index(layout)},"
                                    f"{cp.BODY_MODES.index(mode)},0>", {})
                    slots = best["ns_per_ray_body"] * 1e-9 * sms * 128 * mhz * 1e6
                    r = dict(best, layout=layout, table=table, mode=mode,
                             shape=shape, rays=by_shape[shape],
                             blocks_per_sm=blocks,
                             kernel_ms_turns=[x["kernel_ms"] for x in runs],
                             loop_instructions=loop.get("instructions"),
                             issue_share=(loop["instructions"] * threads / slots
                                          if loop and shape != "one_warp"
                                          else None),
                             sm_clock=clock)
                    readings.append(r)
                    line = (f"{table:7s} {mode:14s} {shape:19s} {layout:5s} "
                            f"rays={r['rays']:6d}: {r['kernel_ms']:9.3f} ms "
                            f"(turns {['%.3f' % t for t in r['kernel_ms_turns']]})"
                            f" {r['ns_per_body']:8.3f} ns/body")
                    if shape != "one_warp":
                        line += (f", {r['ns_per_ray_body'] * 1e3:7.3f} ps/ray-body,"
                                 f" {100 * r['bound_share']:5.2f} % of the bound "
                                 f"(ceiling {100 * cs.BODY_ISSUE_CEILING:.0f} %)")
                    if r["issue_share"] is not None:
                        line += f", issue share {100 * r['issue_share']:5.1f} %"
                    line += f", {blocks} blocks/SM"
                    print(line, flush=True)
    with open(os.path.join(OUT, "readings.json"), "w") as f:
        json.dump({"card": card, "width": WIDTH, "leaf_size": LEAF_SIZE,
                   "bodies": bodies, "sm_clock": clock, "ptxas": ptxas,
                   "sass": sass, "readings": readings}, f, indent=1)
    print(f"card: {cs.nvidia_smi_line()}; SM clock while the bodies run: "
          f"{clock}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
