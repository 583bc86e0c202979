"""Pytest config: mark registration + the cross-variant parity oracle.

NOTE: do not set xla_force_host_platform_device_count here — the device
count is the CI matrix's axis (8-way mesh leg / single-device leg), so
the suite must pass at whatever count the environment provides;
multi-device tests self-skip below their required count
(tests/test_vision_sharding.py, tests/test_parity_sweep.py).

`assert_grouped_parity` is THE reusable oracle for executor-variant
equivalence (unfused == per-layer fused == layer-group megakernel), used
by tests/test_parity_sweep.py's matrix instead of each PR growing its own
ad-hoc parity test.  Import it via the ``parity_oracle`` fixture (tests
must not import conftest directly — pytest owns this module).
"""

import dataclasses
import functools

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is none)")


@functools.lru_cache(maxsize=None)
def _variant_setup(name: str, mode: str):
    """Params/patches (and, for int8, frozen calibration) shared across
    every variant of one (model, mode) — cached so the parity matrix pays
    init + calibration once per cell family, not once per variant."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core.quant import Calibrator
    from repro.models import vision_registry, vit

    cfg = vision_registry.build_cfg(name, fused=True)
    params = vision_registry.init_params(jax.random.PRNGKey(0), cfg)
    imgs = np.random.default_rng(11).standard_normal(
        (2, cfg.image, cfg.image, 3)).astype(np.float32)
    patches = vit.extract_patches(jnp.asarray(imgs), cfg.patch)
    qparams = cal = None
    if mode == "int8":
        qparams = vision_registry.quantize(params)
        cal = Calibrator()
        vision_registry.forward_fn(cfg)(qparams, patches, cfg,
                                        observer=cal)
        cal.freeze()
    return cfg, params, qparams, cal, patches


def assert_grouped_parity(name: str, *, mode: str = "float",
                          group_size: int = 4, mesh=None,
                          mesh_shape=None, backend=None):
    """Cross-variant parity oracle for one (model, mode) cell.

    Runs the SAME params/patches through the unfused per-phase executor,
    the per-layer fused chain, and the layer-group megakernel at
    ``group_size``, then asserts:

      * grouped == per-layer fused BIT-EXACT (single device; the grouped
        kernel performs the identical op sequence per layer) or to 1e-5
        on a mesh (GSPMD may re-tile reductions);
      * grouped (and fused) == unfused within the established executor
        tolerance — float: kernel-chain reassociation; int8: identical
        frozen scales through the in-grid requant chain.

    ``mesh``: a 1-D ``("data",)`` mesh routes every variant through
    `run_schedule_sharded` instead.  ``mesh_shape``: a shape tuple —
    ``(1,)`` single device, ``(8,)`` 1-D data mesh, ``(4, 2)`` /
    ``(2, 4)`` 2-D (data, model) meshes with head-sharded MSA +
    column-sharded MLP — built here so the matrix in
    tests/test_parity_sweep.py stays declarative; cells whose shape
    needs more devices than the host exposes self-skip.  Returns
    (unfused, fused, grouped) logits for callers that want extra
    checks.
    """
    import numpy as np
    from repro.core import schedule as sched_lib
    from repro.models import vision_registry

    if mesh_shape is not None:
        assert mesh is None, "pass mesh= or mesh_shape=, not both"
        import jax
        total = 1
        for d in mesh_shape:
            total *= int(d)
        if total > jax.device_count():
            pytest.skip(f"mesh shape {mesh_shape} needs {total} devices, "
                        f"host exposes {jax.device_count()} "
                        f"(XLA_FLAGS=--xla_force_host_platform_"
                        f"device_count={total})")
        if total > 1:
            from repro.launch.mesh import make_vision_mesh
            mesh = make_vision_mesh(
                data=int(mesh_shape[0]),
                model=int(mesh_shape[1]) if len(mesh_shape) > 1 else 1)

    cfg, params, qparams, cal, patches = _variant_setup(name, mode)
    p = qparams if mode == "int8" else params

    def run(fused: bool, group: int):
        c = dataclasses.replace(cfg, fused=fused, fuse_group=group)
        if backend is not None:
            c = dataclasses.replace(c, backend=backend)
        sched = vision_registry.make_schedule(c)
        if mesh is not None:
            return np.asarray(sched_lib.run_schedule_sharded(
                sched, p, patches, mesh, observer=cal))
        return np.asarray(sched_lib.run_schedule(
            sched, p, patches, observer=cal))

    unfused = run(False, 1)
    fused = run(True, 1)
    grouped = run(True, group_size)
    where = f"{name}/{mode}/g{group_size}"
    if mesh_shape is not None:
        where += "/mesh" + "x".join(str(int(d)) for d in mesh_shape)
    elif mesh is not None:
        where += "/mesh"
    if mesh is None:
        np.testing.assert_array_equal(
            grouped, fused,
            err_msg=f"[{where}] grouped != per-layer fused (bit-exact)")
    else:
        np.testing.assert_allclose(
            grouped, fused, rtol=1e-5, atol=1e-5,
            err_msg=f"[{where}] grouped != per-layer fused on the mesh")
    tol = {"rtol": 2e-4, "atol": 2e-4} if mode == "float" \
        else {"rtol": 2e-5, "atol": 2e-5}
    np.testing.assert_allclose(
        grouped, unfused, err_msg=f"[{where}] grouped != unfused", **tol)
    np.testing.assert_allclose(
        fused, unfused, err_msg=f"[{where}] fused != unfused", **tol)
    return unfused, fused, grouped


@pytest.fixture(scope="session")
def parity_oracle():
    """The cross-variant parity oracle, as a fixture (see
    `assert_grouped_parity`)."""
    return assert_grouped_parity
