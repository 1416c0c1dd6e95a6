"""joblib backend — `with joblib.parallel_backend("ray_tpu_torch"): ...`.

Reference analog: `python/ray/util/joblib/` (`register_ray` +
`ray_backend.py`): scikit-learn et al. parallelize via joblib; registering
this backend fans their batches out as cluster tasks.
"""

from __future__ import annotations

from joblib._parallel_backends import ParallelBackendBase

from ..core import api


class RayTpuBackend(ParallelBackendBase):
    supports_timeout = True
    # Batched tasks already amortize submission overhead.
    supports_retrieve_callback = False

    def configure(self, n_jobs: int = 1, parallel=None, **_kw):
        self.parallel = parallel

        @api.remote
        def _run_batch(batch):
            return batch()

        self._run_batch = _run_batch
        return self.effective_n_jobs(n_jobs)

    def effective_n_jobs(self, n_jobs: int) -> int:
        if n_jobs == 1:
            return 1
        cpus = int(api.cluster_resources().get("CPU", 1))
        return cpus if n_jobs in (-1, None) else min(n_jobs, max(cpus, 1))

    def apply_async(self, func, callback=None):
        ref = self._run_batch.remote(func)
        future = api._global_runtime().as_future(ref)
        if callback is not None:
            future.add_done_callback(lambda f: callback(f.result()))
        return _FutureResult(future)

    # joblib ≥1.4 prefers submit() over apply_async().
    def submit(self, func, callback=None):
        return self.apply_async(func, callback)

    def abort_everything(self, ensure_ready: bool = True):
        if ensure_ready:
            self.configure(n_jobs=self.parallel.n_jobs, parallel=self.parallel)


class _FutureResult:
    def __init__(self, future):
        self._future = future

    def get(self, timeout: float | None = None):
        return self._future.result(timeout=timeout)


def register_ray_tpu():
    """Make `joblib.parallel_backend("ray_tpu_torch")` available."""
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
