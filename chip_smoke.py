#!/usr/bin/env python3
"""Run the main paths on an NVIDIA GPU through the CLI, and check them.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the sharded drivers on four cards

One process drives the card(s); every run goes through
``cmacionize_tpu.cli.main`` at the parameter files' own grid and photon
counts.  One card runs these phases in order:

  stromgren  benchmarks/stromgren.param as written (64^3, 1e6 photons x 20
             iterations): the 50% ionization radius lies within 2% of the
             analytic Stromgren radius.
  march      the default marches (trace_packets_auto and the cascade of the
             H-only driver) against the per-step trace_packets on the same
             2^20 packets through the converged stromgren field: tallies
             agree to 1e-5 in relative L1.
  starbench  --rhd on benchmarks/starbench.param with the total time cut to
             32 of its steps (snapshots every 8): finite fields, rho > 0,
             mass conserved to 1e-5, an ionized region; then 16 steps,
             --restart, 16 more, compared with the straight run to the mass
             tolerance (whether the two are bit-identical is printed, not
             required).
  lexington  benchmarks/lexingtonHII40.param cut to 4 iterations (the 4th
             runs the float64 temperature solve on the card): finite T and
             fractions, T of the ionized core within 5,000-15,000 K.
  solve      the card's float64 state solve of that iteration against the
             same solve on the CPU backend, on 2^15 cells spanning core,
             front and neutral shell: T and fractions agree to the secant's
             tolerance (1e-3 relative) in every cell.
  rates      spectral_tallies_to_ion_integrals on that iteration's tallies
             against a float64 numpy product: 1e-6 relative L1 per row.

``--four-cards`` runs only stromgren at ``--devices 4`` (x-slabs), stromgren
with ``Parallel: tiling: [2, 2, 1]``, the cut starbench at ``--devices 4``,
and the one-card run of each: the sharded fronts lie within 2% of the
one-card front, the sharded RHD mass equals the one-card mass to 1e-5, and
no exchange buffer overflows or superstep cap is hit.

Each phase prints its compile seconds, its steady seconds per iteration or
step, and the process's peak device bytes so far, beside the card's name and
power limit.  The last line of stdout is one JSON object
``{"ok": true, "device": {...}}``.  Without a GPU, or when any phase or
comparison fails, the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHMARKS = os.path.join(HERE, "benchmarks")

#: packets of the march comparison, and of its small-batch timing probe
MARCH_PACKETS = 1 << 20
PROBE_PACKETS = 1 << 12
#: cells of the CPU side of the solve comparison
SOLVE_SUBSET = 1 << 15
#: starbench steps, the restart point and the snapshot cadence, in the
#: file's own steps: its timeline divides 0.141 Myr into 2048 steps (the
#: power of two at or below its 0.000088125 Myr maximum)
STARBENCH_STEP_MYR = 0.141 / 2048
STARBENCH_STEPS = 32
RESTART_STEP = 16
SNAPSHOT_STEPS = 8
LEXINGTON_ITERATIONS = 4

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


class SmokeFailure(Exception):
    """A phase or comparison did not meet its condition."""


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


class CompileClock:
    """Union of JAX's trace/lower/compile time spans (host clock)."""

    def __init__(self):
        self.spans = []

    def __call__(self, event, start, end, **_):
        if event in _COMPILE_EVENTS:
            self.spans.append((start, end))

    def seconds(self, t0, t1):
        total, reach = 0.0, t0
        for start, end in sorted(self.spans):
            start, end = max(start, reach), min(end, t1)
            if end > start:
                total += end - start
                reach = end
        return total


class Recorder:
    """Keeps what the CLI hands its writers and what the drivers compute.

    Installed around each CLI call: snapshot fields (written to disk too
    when h5py is importable), logged warnings, the drivers run, and for
    the multi-element driver each transport and state solve with its
    seconds and inputs.
    """

    def __init__(self, clock, write_files):
        self.clock = clock
        self.write_files = write_files
        self.reset()
        self._saved = []

    def reset(self):
        self.snapshots = []
        self.warnings = []
        self.sims = []
        self.shoots = []
        self.solves = []

    def _patch(self, owner, name, wrapper):
        original = getattr(owner, name)
        self._saved.append((owner, name, original))
        setattr(owner, name, wrapper(original))

    def __enter__(self):
        import jax

        from cmacionize_tpu.io import gadget
        from cmacionize_tpu.models import (
            ionization_simulation,
            multifreq_simulation,
            rhd_simulation,
        )
        from cmacionize_tpu.utils import logging as log_mod

        rec = self

        def writer(original):
            def write(name, geometry, fields, time=0.0, **kwargs):
                rec.snapshots.append((name, float(time), {
                    k: np.asarray(v) for k, v in fields.items()}))
                if rec.write_files:
                    original(name, geometry, fields, time, **kwargs)
            return write

        def warning(original):
            def warn(self, message):
                rec.warnings.append(message)
                return original(self, message)
            return warn

        def run(original):
            def run_and_keep(self, *args, **kwargs):
                rec.sims.append(self)
                return original(self, *args, **kwargs)
            return run_and_keep

        def shoot(original):
            def timed(self, *args):
                t0 = time.time()
                integrals, tally2d = original(self, *args)
                jax.block_until_ready(integrals)
                t1 = time.time()
                rec.shoots.append({
                    "seconds": t1 - t0,
                    "compile": rec.clock.seconds(t0, t1),
                    "tally2d": tally2d, "sim": self})
                return integrals, tally2d
            return timed

        def solve(original):
            def timed(j, h, nd, T_prev, abundances, do_temp, **kwargs):
                t0 = time.time()
                T, xion = original(j, h, nd, T_prev, abundances, do_temp,
                                   **kwargs)
                jax.block_until_ready((T, xion))
                t1 = time.time()
                entry = {"seconds": t1 - t0, "do_temp": do_temp,
                         "compile": rec.clock.seconds(t0, t1)}
                if do_temp and not any(s["do_temp"] for s in rec.solves):
                    entry.update(
                        inputs=(j, h, nd, T_prev, abundances, kwargs),
                        outputs=(T, xion), solve=original)
                rec.solves.append(entry)
                return T, xion
            return timed

        self._patch(gadget, "write_gadget_snapshot", writer)
        if not self.write_files:
            self._patch(gadget, "require_h5py", lambda _: (lambda: None))
        self._patch(log_mod.Log, "warning", warning)
        for cls in (ionization_simulation.HOnlyIonizationSimulation,
                    ionization_simulation.ShardedHOnlyIonizationSimulation,
                    rhd_simulation.RHDSimulation,
                    multifreq_simulation.MultiFreqIonizationSimulation):
            self._patch(cls, "run", run)
        self._patch(multifreq_simulation.MultiFreqIonizationSimulation,
                    "_mc_shoot", shoot)
        self._patch(multifreq_simulation, "solve_cell_state", solve)
        return self

    def __exit__(self, *exc):
        while self._saved:
            owner, name, original = self._saved.pop()
            setattr(owner, name, original)
        return False


class Smoke:
    """Runs the phases and prints one line per measurement."""

    def __init__(self, card, work, write_files):
        import jax

        self.card = card
        self.work = work
        self.clock = CompileClock()
        jax.monitoring.register_event_time_span_listener(self.clock)
        self.recorder = Recorder(self.clock, write_files)

    def say(self, text):
        print(f"[{self.card}] {text}", flush=True)

    def peak_bytes(self, device=None):
        import jax

        stats = (device or jax.devices()[0]).memory_stats() or {}
        return stats.get("peak_bytes_in_use")

    def cli(self, argv, folder, label, units, count):
        """One CLI run in ``folder``; prints compile, steady and peak."""
        from cmacionize_tpu import cli

        os.makedirs(folder, exist_ok=True)
        self.recorder.reset()
        old = os.getcwd()
        os.chdir(folder)
        t0 = time.time()
        try:
            with self.recorder:
                rc = cli.main(argv)
        finally:
            os.chdir(old)
        t1 = time.time()
        check(rc == 0, f"{label}: cli.main returned {rc}")
        compile_s = self.clock.seconds(t0, t1)
        self.say(
            f"{label}: wall {t1 - t0:.3f} s, compile {compile_s:.3f} s, "
            f"steady {(t1 - t0 - compile_s) / count:.4f} s/{units} "
            f"(wall minus compile over {count} {units}s), "
            f"peak device bytes so far {self.peak_bytes()}")
        return self.recorder

    def param_copy(self, name, folder, replace=(), append="", extra=()):
        """Write benchmarks/<name> with text replacements into ``folder``,
        beside copies of the files it reads."""
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(BENCHMARKS, name)) as handle:
            text = handle.read()
        for old, new in replace:
            check(old in text, f"{name}: no {old!r} to replace")
            text = text.replace(old, new)
        path = os.path.join(folder, name)
        with open(path, "w") as handle:
            handle.write(text + append)
        for other in extra:
            shutil.copy(os.path.join(BENCHMARKS, other), folder)
        return path

    # ----------------------------------------------------------- stromgren

    def stromgren(self, label="stromgren", argv=(), param=None):
        sys.path.insert(0, BENCHMARKS)
        import run_stromgren

        param = param or os.path.join(BENCHMARKS, "stromgren.param")
        rec = self.cli(["--params", param, *argv],
                       os.path.join(self.work, label), label, "iteration",
                       20)
        sim = rec.sims[-1]
        xh = rec.snapshots[-1][2]["NeutralFractionH"]
        check(xh.shape == tuple(sim.geometry.shape)
              and bool(np.isfinite(xh).all()),
              f"{label}: neutral fraction not finite or misshapen")
        front = run_stromgren.ionization_radius(xh, sim.geometry)
        analytic = sim.stromgren_radius_analytic()
        self.say(f"{label}: 50% ionization radius {front:.6e} m, analytic "
                 f"{analytic:.6e} m, ratio {front / analytic:.5f} "
                 "(limit 1 +- 0.02)")
        check(abs(front / analytic - 1.0) <= 0.02,
              f"{label}: front off the analytic radius by more than 2%")
        return sim, xh, front

    # --------------------------------------------------------------- march

    def march(self, sim, xh):
        import jax
        import jax.numpy as jnp

        from cmacionize_tpu.models import sources
        from cmacionize_tpu.ops import traversal

        cfg, geom = sim.config, sim.geometry
        shape = geom.shape
        chi = jnp.asarray(
            cfg.number_density * np.asarray(xh, np.float64)
            * cfg.cross_section * float(geom.cell_size[0]),
            jnp.float32).reshape(-1)
        gpos = tuple(float(g) for g in
                     geom.position_to_grid_coords(cfg.source_position))

        def batch(n):
            px, py, pz, dx, dy, dz, tau, _, w = sources.emit_point_source(
                jax.random.PRNGKey(7), n, gpos)
            return traversal.make_packets(
                jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
                tau, w, shape)

        zero = jnp.zeros(chi.shape, jnp.float32)
        block = traversal.default_block(shape)
        marches = {
            "trace_packets": lambda pk: traversal.trace_packets(
                chi, pk, zero, shape=shape)[0],
            "trace_packets_auto": lambda pk: traversal.trace_packets_auto(
                chi, pk, zero, shape=shape)[0],
            "trace_packets_blocked_cascade":
                lambda pk: traversal.trace_packets_blocked_cascade(
                    chi, pk, zero, shape=shape, block=block)[0],
        }

        def timed(fn, pk):
            t0 = time.time()
            out = jax.block_until_ready(fn(pk))
            t1 = time.time()
            out = jax.block_until_ready(fn(pk))
            return out, t1 - t0, time.time() - t1

        packets = batch(MARCH_PACKETS)
        reference, first, steady = timed(marches["trace_packets"], packets)
        ref = np.asarray(reference, np.float64)
        self.say(f"march trace_packets: {MARCH_PACKETS} packets at "
                 f"{shape}: first call {first:.3f} s, steady {steady:.4f} s")
        for name in ("trace_packets_auto", "trace_packets_blocked_cascade"):
            tally, first, steady = timed(marches[name], packets)
            err = float(np.abs(np.asarray(tally, np.float64) - ref).sum()
                        / np.abs(ref).sum())
            self.say(f"march {name}: first call {first:.3f} s, steady "
                     f"{steady:.4f} s; tally vs trace_packets relative L1 "
                     f"{err:.3e} (limit 1e-5, f32 tallies, scatter-add "
                     "order free)")
            check(err <= 1e-5, f"march {name}: tallies differ by {err:.3e}")
        small = batch(PROBE_PACKETS)
        _, _, probe = timed(marches["trace_packets"], small)
        self.say(f"march trace_packets: {PROBE_PACKETS} packets steady "
                 f"{probe:.4f} s = {probe / steady:.3f} of the "
                 f"{MARCH_PACKETS}-packet time (near 1 means the lockstep "
                 "loop is bound by per-iteration overhead, not by packets)")

    # ----------------------------------------------------------- starbench

    def starbench_param(self, folder, steps, restart_every_block=False):
        total = f"total time: {steps * STARBENCH_STEP_MYR!r} Myr"
        snap = f"snapshot time: {SNAPSHOT_STEPS * STARBENCH_STEP_MYR!r} Myr"
        append = ("\nRestartManager:\n  output interval: 0. s\n"
                  if restart_every_block else "")
        return self.param_copy(
            "starbench.param", folder,
            replace=[("total time: 0.141 Myr", total),
                     ("snapshot time: -1 s", snap)],
            append=append, extra=["starbench.yml"])

    def starbench_checks(self, label, rec):
        sim = rec.sims[-1]
        first, last = rec.snapshots[0][2], rec.snapshots[-1][2]
        for name, field in last.items():
            check(np.isfinite(field).all(), f"{label}: {name} not finite")
        check((last["Density"] > 0).all(), f"{label}: rho <= 0 somewhere")
        vol = float(sim.geometry.cell_volume)
        m0 = float(np.sum(first["Density"], dtype=np.float64)) * vol
        m1 = float(np.sum(last["Density"], dtype=np.float64)) * vol
        ionized = int((last["NeutralFractionH"] < 0.5).sum())
        self.say(f"{label}: mass {m0:.9e} -> {m1:.9e} kg, relative change "
                 f"{abs(m1 / m0 - 1):.3e} (limit 1e-5); {ionized} cells "
                 "with xH < 0.5")
        check(abs(m1 / m0 - 1) <= 1e-5, f"{label}: mass not conserved")
        check(ionized > 0, f"{label}: no ionized region")
        return last, m1

    def starbench(self, label="starbench", argv=()):
        folder = os.path.join(self.work, label)
        param = self.starbench_param(folder, STARBENCH_STEPS)
        rec = self.cli(["--rhd", "-p", param, *argv], folder, label,
                       "step", STARBENCH_STEPS)
        return self.starbench_checks(label, rec)

    def starbench_restart(self, straight, straight_mass):
        folder = os.path.join(self.work, "starbench_restart")
        first = self.starbench_param(folder, RESTART_STEP,
                                     restart_every_block=True)
        self.cli(["--rhd", "-p", first], folder,
                 f"starbench {RESTART_STEP} steps", "step", RESTART_STEP)
        param = self.starbench_param(folder, STARBENCH_STEPS)
        rec = self.cli(["--rhd", "-p", param, "--restart", folder], folder,
                       "starbench --restart", "step",
                       STARBENCH_STEPS - RESTART_STEP)
        resumed, mass = self.starbench_checks("starbench resumed", rec)
        rel = abs(mass / straight_mass - 1)
        identical = all(np.array_equal(straight[k], resumed[k])
                        for k in straight)
        diff = max(float(np.max(np.abs(straight[k] - resumed[k])
                                / np.maximum(np.abs(straight[k]), 1e-300)))
                   for k in ("Density", "NeutralFractionH"))
        rest = STARBENCH_STEPS - RESTART_STEP
        self.say(f"starbench restart: {RESTART_STEP} + {rest} steps vs "
                 f"{STARBENCH_STEPS} straight: mass "
                 f"relative difference {rel:.3e} (limit 1e-5); "
                 f"bit-identical: {identical}; max relative field "
                 f"difference {diff:.3e}")
        check(rel <= 1e-5, "starbench restart: mass differs")

    # ----------------------------------------------------------- lexington

    def lexington(self):
        folder = os.path.join(self.work, "lexington")
        param = self.param_copy(
            "lexingtonHII40.param", folder,
            replace=[("number of iterations: 20",
                      f"number of iterations: {LEXINGTON_ITERATIONS}")],
            extra=["lexingtonHII40.yml"])
        rec = self.cli(["-p", param], folder, "lexington", "iteration",
                       LEXINGTON_ITERATIONS)
        for i, (shot, solve) in enumerate(zip(rec.shoots, rec.solves)):
            self.say(
                f"lexington iteration {i + 1}: transport "
                f"{shot['seconds']:.3f} s (compile {shot['compile']:.3f} s), "
                f"state solve {solve['seconds']:.3f} s (compile "
                f"{solve['compile']:.3f} s, temperature: {solve['do_temp']})")
        solved = [s for s in rec.solves if s["do_temp"]]
        check(solved, "lexington: the temperature solve never ran")
        self.say(f"lexington float64 temperature solve at "
                 f"{rec.sims[-1].geometry.shape}: compile "
                 f"{solved[0]['compile']:.3f} s of its first call's "
                 f"{solved[0]['seconds']:.3f} s")
        fields = rec.snapshots[-1][2]
        for name, field in fields.items():
            check(np.isfinite(field).all(), f"lexington: {name} not finite")
        core = (fields["NumberDensity"] > 0) & (
            fields["NeutralFractionH"] < 0.01)
        check(core.any(), "lexington: no ionized core")
        T = fields["Temperature"][core]
        self.say(f"lexington: ionized core {int(core.sum())} cells, T min "
                 f"{T.min():.1f} median {np.median(T):.1f} max {T.max():.1f}"
                 " K (limits 5000-15000 K)")
        check(T.min() >= 5000.0 and T.max() <= 15000.0,
              "lexington: core temperature out of range")
        return rec

    def solve_compare(self, rec):
        import jax

        entry = next(s for s in rec.solves if s["do_temp"])
        (j, h, nd, T_prev, abundances, kwargs) = entry["inputs"]
        T_card, x_card = entry["outputs"]
        geom = rec.sims[-1].geometry
        src = np.asarray(rec.sims[-1].config.source_position)
        radius = np.linalg.norm(geom.cell_centers() - src, axis=-1).ravel()
        n_sub = min(SOLVE_SUBSET, radius.size)
        order = np.argsort(radius, kind="stable")
        idx = order[np.linspace(0, radius.size - 1, n_sub).astype(int)]
        cpu = jax.devices("cpu")[0]

        def take(a):
            return jax.device_put(np.asarray(a).reshape(-1)[idx], cpu)

        t0 = time.time()
        with jax.default_device(cpu):
            T_cpu, x_cpu = entry["solve"](
                {k: take(v) for k, v in j.items()},
                (take(h[0]), take(h[1])), take(nd), take(T_prev),
                abundances, True, **kwargs)
            T_cpu = np.asarray(T_cpu)
        seconds = time.time() - t0

        def rel(card, host):
            card = np.asarray(card).reshape(-1)[idx]
            host = np.asarray(host)
            return np.abs(card - host) / np.maximum(np.abs(host), 1e-12)

        dT = rel(T_card, T_cpu)
        dx = np.max([rel(x_card[k], x_cpu[k]) for k in x_card], axis=0)
        r_xh = np.asarray(x_card["H_n"]).reshape(-1)[idx]
        self.say(
            f"solve: float64 card vs CPU on {n_sub} cells (xH "
            f"{r_xh.min():.2e}..{r_xh.max():.2e}; CPU {seconds:.3f} s): T "
            f"relative difference median {np.median(dT):.3e} max "
            f"{dT.max():.3e}; fractions median {np.median(dx):.3e} max "
            f"{dx.max():.3e} (limit 1e-3 in every cell)")
        check(dT.max() <= 1e-3 and dx.max() <= 1e-3,
              "solve: card and CPU state solves differ")

    def rates_compare(self, rec):
        import jax.numpy as jnp

        from cmacionize_tpu.ops import traversal

        shot = rec.shoots[-1]
        sim = shot["sim"]
        sigma = np.asarray(sim.sigma_table, np.float32)
        heating = np.asarray(sim.heating_weights, np.float32)
        ncell = sim.geometry.n_cells
        card = np.asarray(traversal.spectral_tallies_to_ion_integrals(
            shot["tally2d"], jnp.asarray(sigma), jnp.asarray(heating),
            ncell), np.float64)
        weights = np.concatenate([sigma, heating]).astype(np.float64)
        tally = np.asarray(shot["tally2d"], np.float64).reshape(-1, ncell)
        ref = weights @ tally
        err = np.abs(card - ref).sum(1) / np.maximum(
            np.abs(ref).sum(1), 1e-300)
        elem = np.abs(card - ref) / np.maximum(np.abs(ref), 1e-300)
        self.say(f"rates: spectral_tallies_to_ion_integrals "
                 f"{card.shape} (f32, precision HIGHEST) vs float64 numpy: "
                 f"worst row relative L1 {err.max():.3e} (limit 1e-6), "
                 f"worst element {elem[ref != 0].max():.3e}")
        check(err.max() <= 1e-6, "rates: tally-to-rate product inexact")

    # ------------------------------------------------------------- drivers

    def one_card(self):
        sim, xh, _ = self.stromgren()
        self.march(sim, xh)
        fields, mass = self.starbench()
        self.starbench_restart(fields, mass)
        rec = self.lexington()
        self.rates_compare(rec)
        self.solve_compare(rec)

    def four_cards(self):
        import jax

        devices = jax.devices()[:4]

        def spread(label):
            sim = self.recorder.sims[-1]
            traced = np.asarray(sim.last_diagnostics["packets_traced"])
            peaks = [self.peak_bytes(d) for d in devices]
            self.say(f"{label}: packets traced per device "
                     f"{traced.reshape(-1).tolist()}, peak bytes per device "
                     f"{peaks}")
            for key in ("buffer_overflow", "truncated_live"):
                check(sim.last_diagnostics[key] == 0, f"{label}: {key}")
            check(not any("overflow" in w or "superstep cap" in w
                          for w in self.recorder.warnings),
                  f"{label}: {self.recorder.warnings}")
            check((traced > 0).all(), f"{label}: a device traced nothing")
            if None not in peaks:
                check(min(peaks) >= 0.1 * max(peaks),
                      f"{label}: memory piled onto one device")

        tiled = self.param_copy(
            "stromgren.param", os.path.join(self.work, "stromgren_2x2x1"),
            append="\nParallel:\n  tiling: [2, 2, 1]\n")
        _, _, slabs = self.stromgren("stromgren --devices 4",
                                     ["--devices", "4"])
        spread("stromgren --devices 4")
        _, _, tiles = self.stromgren("stromgren tiling 2x2x1", param=tiled)
        spread("stromgren tiling 2x2x1")
        _, sharded_mass = self.starbench("starbench --devices 4",
                                         ["--devices", "4"])
        spread("starbench --devices 4")
        _, _, single = self.stromgren()
        _, mass = self.starbench()
        for label, front in (("x-slabs (4,1,1)", slabs),
                             ("tiling (2,2,1)", tiles)):
            self.say(f"stromgren {label}: front {front:.6e} m vs one card "
                     f"{single:.6e} m, ratio {front / single:.5f} "
                     "(limit 1 +- 0.02)")
            check(abs(front / single - 1) <= 0.02,
                  f"stromgren {label}: front off the one-card front")
        rel = abs(sharded_mass / mass - 1)
        self.say(f"starbench --devices 4: mass {sharded_mass:.9e} kg vs one "
                 f"card {mass:.9e} kg, relative difference {rel:.3e} "
                 "(limit 1e-5)")
        check(rel <= 1e-5, "starbench --devices 4: mass differs")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run the sharded drivers on four cards")
    args = parser.parse_args(argv)

    # the solve comparison runs a second copy on the CPU backend
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write(
            f"chip_smoke.py needs a GPU; JAX found {devices[0].platform}\n")
        return 2
    if args.four_cards and len(devices) < 4:
        sys.stderr.write(f"--four-cards needs 4 GPUs, found {len(devices)}\n")
        return 2
    sys.path.insert(0, HERE)
    import cmacionize_tpu  # noqa: F401  (fails outside a checkout)

    card = card_line()
    write_files = importlib.util.find_spec("h5py") is not None
    print(f"[{card}] jax {jax.__version__}, {len(devices)} x "
          f"{devices[0].device_kind}; h5py "
          + ("importable: snapshots written to disk" if write_files else
             "not importable: snapshot output off, fields kept in memory")
          + "; PyYAML "
          + ("importable" if importlib.util.find_spec("yaml") else
             "not importable")
          + " (not used)", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        smoke = Smoke(card, work, write_files)
        try:
            smoke.four_cards() if args.four_cards else smoke.one_card()
        except SmokeFailure as failure:
            sys.stderr.write(f"FAILED: {failure}\n")
            return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
