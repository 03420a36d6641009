"""The ``hosts`` part of tools/torch_multichip.py rehearsed on the CPU over
gloo: two torchrun node groups of one rank each (a static rendezvous on
127.0.0.1), each node in a directory of its own with its own copy of the
scene and of the package, on g_blob cut to a 16x16 film (the part's flow
is what is checked: every run is a fresh process):

* rank 0's PFM equals the one-process CLI's byte for byte, rays at 1 spp,
  in turns, and written by rank 0 alone;
* the forest of 4 over the two nodes equals the one-process forest;
* the 2-spp render cut after its first pass and resumed with the
  checkpoint on node 0 only equals the uncut render, and node 1 writes no
  checkpoint;
* every rank reports its own load seconds, and each node its builds.
"""

import json
import os
import shutil
import subprocess
import sys

from simplepath_tpu_torch.parallel import launch

HERE = os.path.dirname(os.path.abspath(__file__))
TOOL = os.path.join(launch.ROOT, "tools", "torch_multichip.py")


def test_the_hosts_part_rehearsed_on_the_cpu(tmp_path):
    scenes = tmp_path / "scenes"
    scenes.mkdir()
    with open(os.path.join(HERE, "scenes", "g_blob.sp")) as f:
        text = f.read()
    (scenes / "g_blob.sp").write_text(
        text.replace("width: 48", "width: 16").replace("height: 48",
                                                       "height: 16"))
    shutil.copy(os.path.join(HERE, "scenes", "blob.ply"), scenes)
    base = {k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run(
        [sys.executable, TOOL, "--platform", "cpu", "--world", "2",
         "--scene", str(scenes / "g_blob.sp"), "--parts", "hosts",
         "--out", str(tmp_path / "out")],
        env=launch.package_env(dict(base, OMP_NUM_THREADS="1")),
        capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    part = next(x for x in lines if x.get("part") == "hosts")
    assert part["ok"] and (part["nodes"], part["ranks_a_node"]) == (2, 1)
    rays = part["rays"]
    assert rays["rank0_pfm_equals_one_gpu"]
    assert [t["where"] for t in rays["turns"]] == ["one", "nodes", "nodes",
                                                   "one"]
    for run in (rays["turns"][1], part["geom"]["nodes"],
                part["resumed"]["nodes"]):
        assert (run["world"], run["backend"]) == (2, "gloo")
        assert run["wrote"] == [True, False]
        assert len(run["load_s"]) == 2 and len(run["nodes"]) == 2
    assert part["geom"]["rank0_pfm_equals_one_process_forest"]
    assert part["geom"]["shards_a_rank"] == 2
    assert part["resumed"]["rank0_pfm_equals_uncut"]
    assert part["resumed"]["checkpoint_samples_on_node0"] == 2
    assert not part["resumed"]["checkpoint_written_on_node1"]
    # each node imported its own copy of the package
    for node in ("node0", "node1"):
        assert os.path.isfile(tmp_path / "out" / "hosts" / node /
                              "simplepath_tpu_torch" / "cli.py")
