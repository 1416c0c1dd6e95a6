"""A world of gloo ranks on the CPU for the port's multi-rank tests (the
port's counterpart of the reference's 8-device fake mesh): `run_world`
starts one process per rank, each runs the named cases of a test module in
order and returns what each case returned, per rank.

The ranks import the test module itself, so its top level must not import
JAX (the reference side of a test computes its expected arrays in the
pytest process, in fixtures). The world rendezvous through a `FileStore`
under the test's temporary directory (no fixed port), each rank runs one
torch thread, and the whole world is killed at its time limit.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent


def run_world(module_file: str, cases, world: int, tmpdir, timeout: float = 240.0) -> dict:
    """{case: [result of rank 0, rank 1, ...]} after every rank ran
    `cases` (names of functions of the module at `module_file`, each
    called with no argument), and under "_seconds" each rank's seconds per
    case. A case that raised on a rank gives a `CaseError` there."""
    tmpdir = Path(tmpdir)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), str(TESTS),
                                                          os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", "import torch_gloo; torch_gloo._rank_main()",
             str(module_file), str(world), str(rank), str(tmpdir), str(timeout), *cases],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)
    ]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode != 0 for p in procs):
        rank = next(r for r, p in enumerate(procs) if p.returncode != 0)
        raise AssertionError(f"the gloo world failed or did not finish within {timeout} s; rank {rank} "
                             f"(exit {procs[rank].returncode}) said:\n{logs[rank][-4000:]}")
    results = {case: [] for case in (*cases, "_seconds")}
    for rank in range(world):
        path = tmpdir / f"rank{rank}.pkl"
        got = pickle.loads(path.read_bytes())
        for case in (*cases, "_seconds"):
            results[case].append(got.get(case, CaseError("not run")))
    return results


class CaseError:
    def __init__(self, text: str):
        self.text = text

    def __repr__(self):
        return f"CaseError:\n{self.text}"


def rank_results(results: dict, case: str) -> list:
    """The case's per-rank results; fails with the first rank's traceback
    if it raised anywhere."""
    got = results[case]
    for rank, r in enumerate(got):
        if isinstance(r, CaseError):
            raise AssertionError(f"{case} failed on rank {rank}:\n{r.text}")
    return got


def _rank_main():
    import faulthandler
    import importlib.util
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    module_file, world, rank, tmpdir, timeout, *cases = sys.argv[1:]
    world, rank = int(world), int(rank)
    faulthandler.dump_traceback_later(max(1.0, float(timeout) - 10.0))  # where a hung rank waits
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store", rank=rank, world_size=world,
                            timeout=timedelta(seconds=90))
    spec = importlib.util.spec_from_file_location(Path(module_file).stem, module_file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if "jax" in sys.modules:
        raise RuntimeError(f"{module_file} imports JAX at its top level: the ranks must not")
    out, seconds = {}, {}
    for case in cases:
        dist.barrier()
        print(f"case {case}", flush=True)
        t0 = time.perf_counter()
        try:
            out[case] = getattr(module, case)()
        except Exception:
            out[case] = CaseError(traceback.format_exc())
        seconds[case] = time.perf_counter() - t0
    out["_seconds"] = seconds
    path = Path(tmpdir) / f"rank{rank}.pkl"
    path.with_suffix(".tmp").write_bytes(pickle.dumps(out))
    path.with_suffix(".tmp").rename(path)
    dist.destroy_process_group()
