"""Run a function on `world` ranks, one Python process a rank on this host,
and collect what each returns.

`run_ranks("package.module:function", world, args, backend)` starts each rank
with `python -c`, the parent's `sys.path` as its `PYTHONPATH` (as
multiprocessing's spawn passes it), so that only the target's own module and
what it imports are loaded. A rank joins the default process group through a
`file://` rendezvous in a fresh temporary directory (no port to collide on),
calls function(rank, world, *args) and writes its JSON-serialisable result;
then it leaves the group. The parent waits for every rank until `timeout`
seconds have passed: a rank that fails, or the deadline, kills every rank
still running and raises, so that a deadlocked collective fails the call
instead of hanging it. Each rank's output goes to a file that the error
quotes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

__all__ = ["run_ranks"]

_BOOT = """
import importlib, json, sys
spec = json.loads(sys.argv[1])
import torch
if spec["threads"]:
    torch.set_num_threads(spec["threads"])
import torch.distributed as dist
dist.init_process_group(spec["backend"], init_method=spec["init"], world_size=spec["world"],
                        rank=spec["rank"])
try:
    module, name = spec["target"].split(":")
    result = getattr(importlib.import_module(module), name)(spec["rank"], spec["world"],
                                                             *spec["args"])
finally:
    dist.destroy_process_group()
with open(spec["out"], "w") as f:
    json.dump(result, f)
"""


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def run_ranks(target: str, world: int, args: Sequence = (), backend: str = "gloo",
              timeout: float = 120.0, threads: Optional[int] = None) -> list:
    """Each rank's return value, in rank order. `threads` sets each rank's
    `torch.set_num_threads` (and OMP_NUM_THREADS)."""
    with tempfile.TemporaryDirectory(prefix="npf_ranks_") as tmp:
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        if threads:
            child_env["OMP_NUM_THREADS"] = str(threads)
        procs, logs = [], []
        for rank in range(world):
            spec = dict(target=target, world=world, rank=rank, args=list(args), backend=backend,
                        init=f"file://{os.path.join(tmp, 'rendezvous')}", threads=threads,
                        out=os.path.join(tmp, f"rank{rank}.json"))
            log = os.path.join(tmp, f"rank{rank}.log")
            with open(log, "w") as f:
                procs.append(subprocess.Popen([sys.executable, "-c", _BOOT, json.dumps(spec)],
                                              stdout=f, stderr=subprocess.STDOUT, env=child_env))
            logs.append(log)
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed:
                    r = failed[0]
                    raise RuntimeError(f"{target}: rank {r} of {world} exited with "
                                       f"{procs[r].returncode}:\n{_tail(logs[r])}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{target}: {world} ranks still running after "
                                       f"{timeout:.0f} s; rank 0's output:\n{_tail(logs[0])}")
                time.sleep(0.05)
            for r, p in enumerate(procs):
                if p.returncode != 0:
                    raise RuntimeError(f"{target}: rank {r} of {world} exited with "
                                       f"{p.returncode}:\n{_tail(logs[r])}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                results.append(json.load(f))
        return results
