"""Properties the GPU path relies on, checked on the CPU: full-precision
contractions, the tally-to-rate product against float64, the default
marches against the per-step reference, and the float64 state solve
staying on the transport's device."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmacionize_tpu.ops import traversal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "cmacionize_tpu")
_CONTRACTIONS = {"einsum", "dot", "matmul", "tensordot", "inner", "vdot"}


def _jax_modules():
    """The package's modules that use jax.numpy."""
    out = []
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            path = os.path.join(root, name)
            if name.endswith(".py"):
                with open(path) as handle:
                    if "jnp" in handle.read():
                        out.append(path)
    return sorted(out)


def _unpinned_contractions(path):
    """jnp contractions without an explicit ``precision=`` (a float32
    product may then run in TF32 on a GPU), and ``@`` on anything."""
    with open(path) as handle:
        tree = ast.parse(handle.read())
    bad = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _CONTRACTIONS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "jnp"
                and not any(k.arg == "precision" for k in node.keywords)):
            bad.append(f"line {node.lineno}: jnp.{node.func.attr}")
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            bad.append(f"line {node.lineno}: @")
    return bad


@pytest.mark.parametrize(
    "path", _jax_modules(), ids=lambda p: os.path.relpath(p, PACKAGE))
def test_contractions_state_their_precision(path):
    assert _unpinned_contractions(path) == []


def test_tally_to_rate_product_matches_float64():
    rng = np.random.default_rng(3)
    n_bins, n_cell, n_rows = 128, 4096, 16
    tally = rng.exponential(1.0, (n_bins, n_cell)).astype(np.float32)
    tally[:, ::7] = 0.0
    sigma = rng.uniform(0, 6e-22, (n_rows - 2, n_bins)).astype(np.float32)
    heating = rng.uniform(0, 1e-7, (2, n_bins)).astype(np.float32)
    got = np.asarray(traversal.spectral_tallies_to_ion_integrals(
        jnp.asarray(tally.reshape(-1)), jnp.asarray(sigma),
        jnp.asarray(heating), n_cell), np.float64)
    weights = np.concatenate([sigma, heating]).astype(np.float64)
    ref = weights @ tally.astype(np.float64)
    err = np.abs(got - ref).sum(1) / np.abs(ref).sum(1)
    assert got.shape == (n_rows, n_cell)
    assert err.max() <= 1e-6


def _stromgren_like(shape=(16, 16, 16), n=1 << 14, seed=5):
    """An opacity field with an ionized core and a neutral shell, and a
    packet batch from the central source."""
    from cmacionize_tpu.models import sources

    idx = np.indices(shape).astype(np.float64)
    centre = (np.asarray(shape, np.float64) / 2.0)[:, None, None, None]
    r = np.sqrt(((idx + 0.5 - centre) ** 2).sum(0))
    chi = np.where(r < 5.0, 1e-3, 2.0).astype(np.float32).reshape(-1)
    px, py, pz, dx, dy, dz, tau, _, w = sources.emit_point_source(
        jax.random.PRNGKey(seed), n, tuple(float(s) / 2 for s in shape))
    packets = traversal.make_packets(
        jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1), tau, w,
        shape)
    return jnp.asarray(chi), packets


@pytest.mark.parametrize("march", ["trace_packets_auto",
                                   "trace_packets_blocked_cascade"])
def test_default_march_matches_per_step_reference(march):
    """The comparison chip_smoke.py makes at 2^20 packets and 64^3 on the
    card: tallies within 1e-5 in relative L1 of trace_packets."""
    shape = (16, 16, 16)
    chi, packets = _stromgren_like(shape)
    zero = jnp.zeros(chi.shape, jnp.float32)
    ref = np.asarray(traversal.trace_packets(
        chi, packets, zero, shape=shape)[0], np.float64)
    if march == "trace_packets_auto":
        got = traversal.trace_packets_auto(chi, packets, zero, shape=shape)
    else:
        got = traversal.trace_packets_blocked_cascade(
            chi, packets, zero, shape=shape,
            block=traversal.default_block(shape))
    got = np.asarray(got[0], np.float64)
    assert np.abs(got - ref).sum() / np.abs(ref).sum() <= 1e-5


@pytest.mark.parametrize("do_temp", [False, True])
def test_multifreq_state_solve_stays_on_device(do_temp, monkeypatch):
    """The f64 state solve runs where the integrals live: no explicit
    device_get/device_put round trip, results on the default device."""
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.multifreq_simulation import (
        MultiFreqConfig,
        MultiFreqIonizationSimulation,
    )
    from cmacionize_tpu.models import ions

    pc = 3.086e16
    config = MultiFreqConfig(
        geometry=GridGeometry((-pc,) * 3, (2 * pc,) * 3, (8, 8, 8)),
        number_density=1e8, initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0), luminosity=1e48,
        spectrum_type="planck", spectrum_temperature=40000.0,
        spectrum_frequency=3.3e15, n_photons=4096, n_iterations=1,
        abundances=dict(ions.DEFAULT_ABUNDANCES), do_temperature=True,
        diffuse_field=False)
    sim = MultiFreqIonizationSimulation(config, seed=3)
    n_cell = config.geometry.n_cells
    rng = np.random.default_rng(0)
    integrals = jnp.asarray(
        rng.uniform(0.0, 1e-3, (ions.NUMBER_OF_IONS + 2, n_cell)),
        jnp.float32)

    def refuse(*args, **kwargs):
        raise AssertionError("state solve moved data through the host")

    monkeypatch.setattr(jax, "device_get", refuse)
    monkeypatch.setattr(jax, "device_put", refuse)
    T, xion, j = sim._solve_state(integrals, do_temp)
    monkeypatch.undo()
    default = jax.devices()[0]
    for array in [T, *xion.values(), *j.values()]:
        assert array.devices() == {default}
        assert array.dtype == jnp.float64
    assert np.isfinite(np.asarray(T)).all()
