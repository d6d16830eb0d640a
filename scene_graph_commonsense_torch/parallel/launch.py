"""Starting the processes of one group on this host: one per rank, waited
for together under one deadline, none left running."""

from __future__ import annotations

import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple


def run_processes(argvs: Sequence[Sequence[str]], cwd: str,
                  env: Optional[Dict[str, str]] = None,
                  logs: Optional[Sequence[str]] = None,
                  timeout: float = 600.0) -> Tuple[List[int], bool]:
    """Starts one process per argv and waits for all of them, `timeout`
    seconds in all; kills any left then.  Returns (exit codes, timed out).
    With `logs` each process writes its output and errors to its own file
    (a pipe left unread could block a rank that its peers wait for);
    without, it inherits this process's."""
    procs = []
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        for i, argv in enumerate(argvs):
            out = open(logs[i], "w") if logs else None
            try:
                procs.append(subprocess.Popen(
                    list(argv), cwd=cwd, env=env, stdout=out,
                    stderr=subprocess.STDOUT if out else None))
            finally:
                if out:
                    out.close()
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], timed_out
