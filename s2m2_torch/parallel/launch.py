"""Start local ranks as subprocesses and wait for all of them.

    outs = run_ranks(lambda rank, init: [sys.executable, "-m", "pkg.mod",
                                         "--rank", str(rank), "--init", init],
                     world=2, timeout=120)

`init` is a `tcp://127.0.0.1:<free port>` address for
`distributed.initialize_distributed`. Every rank's standard output and
error go to files, so a full pipe never stalls a rank. A rank that exits
non-zero, or a run that outlasts `timeout`, kills the ranks still running
and raises with every rank's exit code and the end of its output. Returns
each rank's standard output, in rank order.
"""
from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RanksFailed(RuntimeError):
    pass


def run_ranks(argv_of, world, *, timeout=300.0, env=None, cwd=None, tail=4000):
    """Run argv_of(rank, init) for rank 0 .. world - 1 at once; see the
    module docstring."""
    init = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        procs, files = [], []
        try:
            for rank in range(world):
                out = open(os.path.join(tmp, f"rank{rank}.out"), "w+")
                err = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
                files.append((out, err))
                procs.append(subprocess.Popen(argv_of(rank, init), stdout=out, stderr=err,
                                              env=env, cwd=cwd))
            deadline = time.monotonic() + timeout
            failed = timed_out = False
            while not failed and any(p.poll() is None for p in procs):
                failed = any(p.poll() not in (None, 0) for p in procs)
                timed_out = time.monotonic() > deadline
                if timed_out:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        texts = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    codes = [p.returncode for p in procs]
    if timed_out or any(codes):
        what = f"timed out after {timeout} s" if timed_out else "failed"
        report = "\n".join(f"--- rank {r}: exit {c}\n[stdout]\n{o[-tail:]}\n[stderr]\n"
                           f"{e[-tail:]}" for r, (c, (o, e)) in enumerate(zip(codes, texts)))
        raise RanksFailed(f"{world} ranks {what}:\n{report}")
    return [o for o, _ in texts]
