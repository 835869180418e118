"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see 1 real device;
only launch/dryrun.py forces 512 host devices (per spec).

Sanitizer mode (``HNTL_SANITIZE=1``): wraps the store's fused and
sharded search methods in ``jax.transfer_guard("disallow")`` so any
*implicit* host<->device transfer on the data plane fails the test that
triggered it.  Explicit placement (``jax.device_put`` of the filter
scalars, ``jax.device_get`` of the final top-k) and the cold tier's
host memmap re-rank — the one sanctioned transfer point — stay legal.
``HNTL_NAN_DEBUG=1`` additionally flips ``jax_debug_nans`` globally
(kept a separate knob: build-time fitters use NaN masking on padded
rows by design, so NaN-trapping the whole suite is opt-in).
"""
import os

import numpy as np
import pytest

try:                                   # hypothesis is a dev-only dependency
    from hypothesis import settings

    # CI runs with --hypothesis-profile=ci: derandomized (fixed seed per
    # test, printed on failure) so property failures reproduce exactly and
    # the tier-1 gate never flakes on an unlucky draw.
    settings.register_profile("ci", derandomize=True, deadline=None,
                              print_blob=True)
except ImportError:                    # pragma: no cover
    pass

SANITIZE = os.environ.get("HNTL_SANITIZE") == "1"


def _install_sanitizer():
    import functools

    import jax

    from repro.core.store import VectorStore

    if os.environ.get("HNTL_NAN_DEBUG") == "1":
        jax.config.update("jax_debug_nans", True)

    for name in ("_search_segments_fused", "_search_segments_sharded",
                 "_search_segments_tiered"):
        orig = getattr(VectorStore, name)

        def guarded(self, *args, _orig=orig, **kwargs):
            with jax.transfer_guard("disallow"):
                return _orig(self, *args, **kwargs)

        functools.update_wrapper(guarded, orig)
        guarded._hntl_sanitized = True
        setattr(VectorStore, name, guarded)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running suites (the recall-under-drift regression); "
        "deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the PyTorch port's kernels); skips without "
        "one; select with -m gpu")
    if SANITIZE:
        _install_sanitizer()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def plane_counters(monkeypatch):
    """Central data-plane counters: plane (re-)stacks, fused dispatches,
    and jit compile-cache sizes of the planner entry points.

    Replaces the per-test monkeypatch counters that PRs 3-7 each
    re-invented: tests assert the zero-re-stack / zero-recompile
    contract through one fixture.  Compile counts come from the jitted
    functions' own cache (``_cache_size()``), so a cache miss anywhere —
    new static combo, new pytree structure — is visible even if the
    dispatch count stays flat."""
    from repro.core import planner, store as store_mod

    jit_fns = {
        "search": planner.search,
        "search_stacked": planner.search_stacked,
        "search_stacked_sharded": planner.search_stacked_sharded,
    }

    class PlaneCounters:
        def __init__(self):
            self.stacks = 0
            self.dispatches = 0          # fused search_stacked calls
            self.dispatches_sharded = 0

        def jit_snapshot(self):
            return {k: f._cache_size() for k, f in jit_fns.items()}

        def compiles_since(self, snap):
            now = self.jit_snapshot()
            return {k: now[k] - snap[k] for k in now}

        def total_compiles_since(self, snap):
            return sum(self.compiles_since(snap).values())

    counters = PlaneCounters()

    orig_stack = store_mod.stack_segments

    def counting_stack(*args, **kwargs):
        counters.stacks += 1
        return orig_stack(*args, **kwargs)

    orig_dispatch = planner.search_stacked

    def counting_dispatch(*args, **kwargs):
        counters.dispatches += 1
        return orig_dispatch(*args, **kwargs)

    orig_dispatch_sh = planner.search_stacked_sharded

    def counting_dispatch_sh(*args, **kwargs):
        counters.dispatches_sharded += 1
        return orig_dispatch_sh(*args, **kwargs)

    monkeypatch.setattr(store_mod, "stack_segments", counting_stack)
    monkeypatch.setattr(planner, "search_stacked", counting_dispatch)
    monkeypatch.setattr(planner, "search_stacked_sharded",
                        counting_dispatch_sh)
    return counters
