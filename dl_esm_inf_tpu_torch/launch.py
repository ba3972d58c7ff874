"""Local multi-process launcher: ``python -m dl_esm_inf_tpu_torch.launch``.

The counterpart of ``dl_esm_inf_tpu/launch.py``, the equivalent of
``mpirun -np N python script.py``: spawns N copies of a script (or of a
module, ``-m``), each one rank, wired together through torch's own
environment protocol (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``) that
:func:`~.parallel.environment.initialise` reads.  Every rank of one
launch runs on this host; on a machine with one card all ranks share it.

    python -m dl_esm_inf_tpu_torch.launch -n 2 my_model_script.py [args...]
    python -m dl_esm_inf_tpu_torch.launch -n 4 -m some.module [args...]

The first rank that exits nonzero terminates the rest (an mpirun-style
abort), and no rank outlives the launcher.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(script: str | None, args, num_processes: int = 2,
           port: int | None = None, base_env: dict | None = None, *,
           module: str | None = None, timeout: float | None = None,
           stderr=None) -> int:
    """Spawn ``num_processes`` ranks of ``script`` (or of ``module``);
    returns the first nonzero exit code (0 if all succeed).
    ``port=None`` picks a free rendezvous port (concurrent launches on one
    host must not collide); ``base_env`` replaces the inherited
    environment.  ``timeout`` (seconds) bounds the whole gang: past it
    every rank is stopped and ``TimeoutError`` raised.  ``stderr``: a
    file every rank writes its standard error to (default: this
    process's)."""
    if (script is None) == (module is None):
        raise ValueError("give exactly one of script and module")
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if port is None:
        port = _free_port()
    target = [script] if module is None else ["-m", module]
    procs = []
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    try:
        for rank in range(num_processes):
            env = dict(os.environ if base_env is None else base_env)
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       RANK=str(rank), WORLD_SIZE=str(num_processes),
                       LOCAL_RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, *target, *args], env=env, stderr=stderr))
        # Poll the whole gang: the first rank to die with a nonzero
        # status terminates the rest, instead of survivors blocking in a
        # collective until its timeout.
        live = list(procs)
        while live and not rc:
            time.sleep(0.1)
            live = [p for p in live if p.poll() is None]
            rc = next((p.returncode for p in procs
                       if p.returncode not in (None, 0)), 0)
            if deadline is not None and live and time.monotonic() > deadline:
                raise TimeoutError(f"{num_processes}-rank gang still "
                                   f"running after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


def main(argv=None):
    """``[-n N] [--port P] (script | -m module) [args...]``: the launcher's
    options come first; everything after the script or module is the
    program's."""
    ap = argparse.ArgumentParser(
        prog="python -m dl_esm_inf_tpu_torch.launch",
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--port", type=int, default=None,
                    help="rendezvous port (default: pick a free one)")
    ap.add_argument("-m", dest="module", default=None,
                    help="run a module as the program, as python -m does")
    argv = list(sys.argv[1:] if argv is None else argv)
    # split where the program starts: after "-m module", or at the first
    # argument that is not one of the launcher's options
    i = 0
    while i < len(argv):
        if argv[i] == "-m":
            i += 2
            break
        if argv[i] in ("-n", "--num-processes", "--port"):
            i += 2
        elif argv[i].startswith(("--num-processes=", "--port=")) or (
                argv[i].startswith("-n") and len(argv[i]) > 2):
            i += 1
        elif argv[i] in ("-h", "--help"):
            ap.parse_args(argv[i:i + 1])
        else:
            break
    ns = ap.parse_args(argv[:i])
    rest = argv[i:]
    script = None
    if ns.module is None:
        if not rest:
            ap.error("a script (or -m module) is required")
        script, rest = rest[0], rest[1:]
    sys.exit(launch(script, rest, ns.num_processes, ns.port,
                    module=ns.module))


if __name__ == "__main__":
    main()
