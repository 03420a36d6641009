"""Start a group of processes and end them all as soon as one fails.

The ranks of a multi-process job wait for each other inside collectives, so
a rank that dies can leave the others waiting until their process group's
timeout.  :func:`run_processes` starts one process a command, each in a
session of its own (a ``torchrun`` command takes its workers with it), and
polls them: the first that exits non-zero (after a few seconds' grace for
the others to end by themselves), or the time limit, kills every process
still running, whole session and all, and raises
:class:`RanksFailed` naming the processes that failed with the end of their
output.  :func:`rank_env` is the environment ``torchrun`` gives a rank,
without the TCP rendezvous: a caller that starts its ranks itself pairs it
with a ``file://`` rendezvous (``multihost.init_distributed``).
"""

from __future__ import annotations

import os
import signal
import subprocess
import time

__all__ = ["RanksFailed", "run_processes", "rank_env", "package_env"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# the end of a failed process's output that RanksFailed quotes
TAIL_CHARS = 3000
# seconds the other processes have, once one has failed, before they are
# killed
GRACE_S = 5.0


class RanksFailed(RuntimeError):
    """One or more processes of a group failed or ran past the limit."""


def package_env(base: dict | None = None) -> dict:
    """``base`` (default: this process's environment) with this package's
    directory first on ``PYTHONPATH``, so that a child started anywhere
    imports it."""
    env = dict(os.environ if base is None else base)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH", "")) if p)
    return env


def rank_env(rank: int, world: int, base: dict | None = None) -> dict:
    """The environment of rank ``rank`` of ``world`` on this host: the
    variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``) over :func:`package_env`."""
    env = package_env(base)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world))
    return env


def _kill(proc: subprocess.Popen) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_processes(cmds: list, envs: list | None, log_dir: str,
                  timeout: float, names: list | None = None,
                  cwd: str | None = None) -> list:
    """Run every command of ``cmds`` at once (``envs[i]`` its environment,
    None: this process's) and wait for all → each one's output (stdout and
    stderr together, also kept in ``log_dir/<name>.log``).

    A process that exits non-zero (GRACE_S seconds later), or ``timeout``
    seconds passing, kills every process still running, with the session
    it leads, and raises :class:`RanksFailed` with the last TAIL_CHARS
    characters of the output of each process that did not exit 0.  ``names`` label the processes (default ``rank 0``,
    ``rank 1``, ...)."""
    names = names or [f"rank {i}" for i in range(len(cmds))]
    envs = envs or [None] * len(cmds)
    os.makedirs(log_dir, exist_ok=True)
    paths = [os.path.join(log_dir, n.replace(" ", "_") + ".log")
             for n in names]
    logs = [open(p, "w+") for p in paths]
    procs, killed = [], []
    failed = None
    try:
        for cmd, env, log in zip(cmds, envs, logs):
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, start_new_session=True))
        deadline = time.time() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes:
                if any(codes):
                    failed = "failed"
                break
            if any(c not in (None, 0) for c in codes) and failed is None:
                # the others get a moment to end, or to print their own
                # error, before they are killed
                failed = "failed"
                deadline = min(deadline, time.time() + GRACE_S)
            if time.time() > deadline:
                failed = failed or f"still running after {timeout:.0f} s"
                break
            time.sleep(0.1)
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                _kill(p)
                killed.append(i)
            p.wait()
    out = []
    for f in logs:
        f.seek(0)
        out.append(f.read())
        f.close()
    if failed is not None:
        # named: the processes that failed by themselves (at the time limit,
        # those still running); quoted: every one that did not exit 0, the
        # ended ones too (a rank that raised may still be unwinding when a
        # peer it left fails first)
        bad = [i for i, p in enumerate(procs) if p.returncode != 0
               and (i not in killed) == (failed == "failed")]
        quoted = bad + [i for i in killed if i not in bad]
        raise RanksFailed(
            f"{', '.join(names[i] for i in bad)} {failed}"
            + (f" ({', '.join(names[i] for i in killed)} ended)"
               if failed == "failed" and killed else "") + ":\n"
            + "\n".join(f"--- {names[i]} (exit {procs[i].returncode}):\n"
                        f"{out[i][-TAIL_CHARS:]}" for i in quoted))
    return out
