"""Command-line entry point.

Equivalent of the reference's CMacIonize main
(/root/reference/src/CMacIonize.cpp:100-377): parse flags, load the
parameter file, dispatch into a run mode, write snapshots.  The reference's
`--task-based` flags select its second-generation scheduler; here both
generations map onto the same bulk-synchronous implementation, so the flags
are accepted and simply logged.

Usage:
    python -m cmacionize_tpu --params benchmarks/stromgren.param
    python -m cmacionize_tpu --rhd --params starbench.param
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from cmacionize_tpu.utils.logging import TerminalLog
from cmacionize_tpu.utils.params import ParameterFile


def _write_snapshot(params, geometry, fields, time_value, log):
    from cmacionize_tpu.io.gadget import write_gadget_snapshot

    prefix = params.get_string("DensityGridWriter:prefix", "snapshot_")
    padding = params.get_int("DensityGridWriter:padding", 3)
    folder = params.get_string("DensityGridWriter:folder", ".")
    counter = 0
    name = os.path.join(folder, f"{prefix}{counter:0{padding}d}.hdf5")
    while os.path.exists(name):
        counter += 1
        name = os.path.join(folder, f"{prefix}{counter:0{padding}d}.hdf5")
    write_gadget_snapshot(name, geometry, fields, time_value, params=params)
    log.status(f"wrote snapshot {name}")
    return name


def _writes_gadget_snapshots(args, params) -> bool:
    """True when the selected mode reads or writes Gadget HDF5 snapshots
    (RHD, emissivity post-processing, ionization on a Cartesian grid)."""
    if args.rhd or args.task_based_rhd or args.emission:
        return True
    if args.dusty_radiative_transfer:
        return False
    return params.get_string("DensityGrid:type", "Cartesian") not in (
        "AMR", "Voronoi")


def _parallel_config(params, n_devices_flag=0):
    """Resolve the ``Parallel:`` block (+ --devices override).

    Returns (n_devices, tiling).  n_devices == 1 → single-device run.
    The reference reserves this role for its MPI layer
    (/root/reference/src/MPICommunicator.hpp); here it selects the
    domain-decomposed drivers over a jax device mesh.
    """
    import jax

    n_dev = n_devices_flag or params.get_int("Parallel:number of devices", 1)
    if n_dev < 0:  # -1 → all available devices
        n_dev = len(jax.devices())
    tiling = None
    if params.has_value("Parallel:tiling"):
        tiling = tuple(params.get_int_vector("Parallel:tiling"))
        n_dev = tiling[0] * tiling[1] * tiling[2]
    elif n_dev > 1:
        tiling = (n_dev, 1, 1)
    avail = len(jax.devices())
    if n_dev > avail:
        raise SystemExit(
            f"Parallel: requested {n_dev} devices, only {avail} available")
    return n_dev, tiling


def _run_ionization(params, log, seed, n_devices_flag=0):
    """Photoionization post-processing (classic / task-based modes).

    ``DensityGrid:type`` dispatches over the grid families like the
    reference's DensityGridFactory
    (/root/reference/src/DensityGridFactory.hpp:73-77): Cartesian (default),
    AMR, Voronoi.  The AMR/Voronoi paths run the H-only driver on their
    respective grids.  A ``Parallel:`` block (or ``--devices``) selects the
    domain-decomposed drivers (Cartesian only).
    """
    grid_type = params.get_string("DensityGrid:type", "Cartesian")
    n_dev, tiling = _parallel_config(params, n_devices_flag)
    if grid_type in ("AMR", "Voronoi"):
        # AMR/Voronoi distribute via replicated-grid photon DP — the same
        # strategy the reference uses for these grids (its only distributed
        # mode for them: classic MPI, IonizationSimulation.cpp:395-529)
        mesh = None
        if n_dev > 1:
            from cmacionize_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(n_dev, axis_names=("ph",))
            log.status(
                f"photon data parallelism: {n_dev} devices, "
                f"replicated {grid_type} grid")
        return _run_ionization_special_grid(
            params, log, seed, grid_type, mesh=mesh)
    multi_element = (
        params.get_bool("TemperatureCalculator:do temperature calculation", False)
        or params.get_bool("IonizationSimulation:diffuse field", False)
        or not params.get_string("PhotonSourceSpectrum:type", "Monochromatic")
        .lower()
        .startswith("mono")
    )
    if multi_element:
        import jax

        jax.config.update("jax_enable_x64", True)
        from cmacionize_tpu.models.multifreq_simulation import (
            MultiFreqConfig,
            MultiFreqIonizationSimulation,
        )

        config = MultiFreqConfig.from_params(params)
        if params.has_value("TrackerManager:filename"):
            # raising the photon budget for tracked runs mirrors
            # TaskBasedIonizationSimulation.cpp:671-672
            import dataclasses as _dc

            min_photons = params.get_int(
                "TrackerManager:minimum number of photon packets", 0)
            if min_photons > config.n_photons:
                config = _dc.replace(config, n_photons=min_photons)
        density = init_T = None
        if params.get_string("DensityFunction:type", "Homogeneous") != "Homogeneous":
            from cmacionize_tpu.models.density_functions import (
                density_function_from_params,
            )

            df = density_function_from_params(params, config.geometry)
            density = df.number_density
            init_T = df.temperature
        mesh = None
        if n_dev > 1:
            from cmacionize_tpu.parallel.mesh import make_mesh

            if tiling is not None and (tiling[1] != 1 or tiling[2] != 1):
                raise SystemExit(
                    "Parallel: the multi-frequency driver shards x-slabs; "
                    "use tiling [N, 1, 1]")
            mesh = make_mesh(n_dev, axis_names=("x",))
            log.status(
                f"domain decomposition: {n_dev} devices, x-slabs")
        sim = MultiFreqIonizationSimulation(
            config, log=log, seed=seed, density=density,
            initial_temperature=init_T, mesh=mesh,
        )
        cell_trackers = None
        if params.has_value("TrackerManager:filename"):
            from cmacionize_tpu.models.trackers import CellTrackers

            cell_trackers = CellTrackers.from_reference_yaml(
                config.geometry,
                params.get_string("TrackerManager:filename"),
                sim.bin_edges,
            )
            sim.attach_cell_trackers(cell_trackers)
            log.status(
                f"placed {cell_trackers.n_track} tracker(s) from "
                + params.get_string("TrackerManager:filename"))
        xion, temperature = sim.run(
            restart_manager=_optional_restart_manager(params))
        if cell_trackers is not None:
            from cmacionize_tpu.models import ions as ions_mod

            written = cell_trackers.write_outputs(
                ".", sigma_table=sim.sigma_table,
                ion_names=ions_mod.ION_NAMES)
            log.status(f"wrote {len(written)} tracker output(s)")
        fields = {
            "NumberDensity": np.asarray(sim.number_density),
            "Temperature": np.asarray(temperature),
            "NeutralFractionH": np.clip(np.asarray(xion["H_n"]), 0, 1),
            "NeutralFractionHe": np.clip(np.asarray(xion["He_n"]), 0, 1),
        }
        for name in xion:
            if name not in ("H_n", "He_n"):
                fields[f"NeutralFraction{name}"] = np.asarray(xion[name])
    else:
        from cmacionize_tpu.models.ionization_simulation import (
            HOnlyConfig,
            HOnlyIonizationSimulation,
        )

        config = HOnlyConfig.from_params(params)
        if n_dev > 1:
            from cmacionize_tpu.models.ionization_simulation import (
                ShardedHOnlyIonizationSimulation,
            )

            log.status(
                f"domain decomposition: {n_dev} devices, tiling {tiling}")
            sim = ShardedHOnlyIonizationSimulation(
                config, tiling=tiling, log=log, seed=seed)
        else:
            sim = HOnlyIonizationSimulation(config, log=log, seed=seed)
        xh = sim.run(restart_manager=_optional_restart_manager(params))
        fields = {
            "NumberDensity": np.asarray(sim.number_density),
            "Temperature": np.full(config.geometry.shape, config.temperature),
            "NeutralFractionH": np.asarray(xh),
        }
    _write_snapshot(params, config.geometry, fields, 0.0, log)


def _run_ionization_special_grid(params, log, seed, grid_type, mesh=None):
    """H-only photoionization on an AMR or Voronoi grid.

    ``mesh``: optional device mesh for replicated-grid photon data
    parallelism (packets split over devices, tallies psum'd — the
    reference's classic MPI mode for these grid families)."""
    import numpy as np

    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.ionization_simulation import HOnlyConfig

    geometry = GridGeometry.from_params(params)
    config = HOnlyConfig.from_params(params)

    # Honor any DensityFunction type (not just Homogeneous): build the field
    # on the Cartesian lattice once and nearest-sample it at arbitrary
    # positions, so Mass/Opacity/OI refinement criteria see the real
    # structure (cf. DensityFunctionFactory.hpp:138-174).
    if params.get_string("DensityFunction:type", "Homogeneous") == "Homogeneous":
        density_callable = (
            lambda pos: np.full(len(np.atleast_2d(pos)), config.number_density)
        )
    else:
        from cmacionize_tpu.models.density_functions import (
            density_function_from_params,
        )

        _df = density_function_from_params(params, geometry)
        _nd = np.asarray(_df.number_density)
        _anchor = np.asarray(geometry.anchor)
        _cell = np.asarray(geometry.cell_size)
        _shape = np.asarray(geometry.shape)

        def density_callable(pos):
            idx = ((np.atleast_2d(pos) - _anchor) / _cell).astype(int)
            idx = np.clip(idx, 0, _shape - 1)
            return _nd[tuple(idx.T)]

    # multi-element conditions mirror the Cartesian dispatch
    multi_element = (
        params.get_bool(
            "TemperatureCalculator:do temperature calculation", False)
        or params.get_bool("IonizationSimulation:diffuse field", False)
        or not params.get_string("PhotonSourceSpectrum:type", "Monochromatic")
        .lower().startswith("mono")
    )
    mf_kwargs = dict(
        source_position=config.source_position,
        luminosity=config.luminosity,
        n_photons=config.n_photons,
        do_temperature=params.get_bool(
            "TemperatureCalculator:do temperature calculation", False),
        diffuse_field=params.get_bool(
            "IonizationSimulation:diffuse field", False),
        spectrum_temperature=params.get_physical_value(
            "PhotonSourceSpectrum:temperature", "temperature", "40000. K"),
        seed=seed,
        mesh=mesh,
    )
    extra_fields = {}
    if grid_type == "AMR":
        from cmacionize_tpu.models import amr

        scheme = amr.refinement_scheme_from_params(params)
        max_level = params.get_int(
            "DensityGrid:AMRRefinementScheme:maximum refinement level", 2)
        if multi_element:
            grid = amr.build_amr_grid(
                geometry, scheme, density_callable, max_level=max_level)
            sim = amr.MultiFreqAMRSimulation(
                grid, density_callable, **mf_kwargs)
            xion, T = sim.run(
                config.n_iterations,
                restart_manager=_optional_restart_manager(params))
            xh = np.clip(np.asarray(xion["H_n"]), 0, 1)
            extra_fields = {
                "temperature": np.asarray(T),
                "neutral_fraction_He": np.clip(
                    np.asarray(xion["He_n"]), 0, 1),
            }
            n_cells, lvl = grid.n_cells, grid.max_level
        else:
            sim = amr.AMRIonizationSimulation(
                geometry, scheme,
                density_callable,
                source_position=config.source_position,
                luminosity=config.luminosity,
                cross_section=config.cross_section,
                recombination_rate=config.recombination_rate,
                n_photons=config.n_photons,
                max_level=max_level,
                seed=seed,
                mesh=mesh,
            )
            xh = np.asarray(sim.run(
                config.n_iterations,
                restart_manager=_optional_restart_manager(params)))
            n_cells, lvl = sim.grid.n_cells, sim.grid.max_level
            log.status(f"ionized volume {sim.ionized_volume():.4g} m^3")
        log.status(f"AMR grid: {n_cells} leaves (max level {lvl})")
    else:
        from cmacionize_tpu.models import voronoi

        rng = np.random.default_rng(seed)
        generators = voronoi.generators_from_params(params, rng)
        grid = voronoi.build_voronoi_grid(
            geometry, generators,
            num_lloyd=params.get_int(
                "DensityGrid:number of Lloyd iterations", 0))
        if multi_element:
            sim = voronoi.MultiFreqVoronoiSimulation(
                grid, density_callable, **mf_kwargs)
            xion, T = sim.run(
                config.n_iterations,
                restart_manager=_optional_restart_manager(params))
            xh = np.clip(np.asarray(xion["H_n"]), 0, 1)
            extra_fields = {
                "temperature": np.asarray(T),
                "neutral_fraction_He": np.clip(
                    np.asarray(xion["He_n"]), 0, 1),
            }
        else:
            sim = voronoi.HOnlyVoronoiSimulation(
                grid, density_callable,
                source_position=config.source_position,
                luminosity=config.luminosity,
                cross_section=config.cross_section,
                recombination_rate=config.recombination_rate,
                n_photons=config.n_photons,
                seed=seed,
                mesh=mesh,
            )
            xh = np.asarray(sim.run(
                config.n_iterations,
                restart_manager=_optional_restart_manager(params)))
            log.status(f"ionized volume {sim.ionized_volume():.4g} m^3")
        log.status(f"Voronoi grid: {grid.n_cells} cells")
    out = params.get_string("DensityGridWriter:prefix", "snapshot_") +         "cells.npz"
    np.savez(out, neutral_fraction=xh, **extra_fields)
    log.status(f"wrote per-cell neutral fractions -> {out}")


def _optional_restart_manager(params):
    """Opt-in RestartManager for the ionization modes (the reference's
    classic driver checkpoints only when configured; RHD always does)."""
    if (params.has_value("RestartManager:path")
            or params.has_value("RestartManager:output interval")):
        return _restart_manager_from_params(params)
    return None


def _restart_manager_from_params(params, default_path="."):
    """RestartManager from the reference's parameter block
    (/root/reference/src/RestartManager.hpp:108-122: path, output interval,
    maximum number of backups, maximum time, resubmit command)."""
    from cmacionize_tpu.io.restart import RestartManager

    return RestartManager(
        path=params.get_string("RestartManager:path", default_path),
        interval_seconds=params.get_physical_value(
            "RestartManager:output interval", "time", "3600. s"),
        max_keep=params.get_int(
            "RestartManager:maximum number of backups", 1) + 1,
        max_walltime=params.get_physical_value(
            "RestartManager:maximum time", "time", "118. h"),
        resubmit_command=params.get_string(
            "RestartManager:resubmit command", ""),
    )


def _run_rhd(params, log, seed, n_devices_flag=0, restart_folder=""):
    """Radiation hydrodynamics (starbench/bondi-class problems).

    All physics selection — external potentials, self-gravity, cooling,
    turbulence forcing, hydro masks, Bondi boundaries, time-dependent
    sources + stellar feedback — happens in RHDSimulation.from_params
    (mirroring /root/reference/src/RadiationHydrodynamicsSimulation.cpp:250-392).

    The production loop writes a NUMBERED snapshot series every
    ``snapshot time`` (default total/10) plus the t=0 and final states —
    the same series the reference's starbench analysis scripts consume
    (RadiationHydrodynamicsSimulation.cpp:667-676) — and a
    StatisticsLogger.txt conservation log (``output statistics``,
    default true, :368-374).
    """
    from cmacionize_tpu import constants
    from cmacionize_tpu.io.gadget import write_gadget_snapshot
    from cmacionize_tpu.models.rhd_simulation import RHDSimulation
    from cmacionize_tpu.ops import hydro as hydro_mod

    n_dev, tiling = _parallel_config(params, n_devices_flag)
    if params.get_string("DensityGrid:type", "Cartesian") == "Voronoi":
        return _run_rhd_voronoi(params, log, seed, n_dev, restart_folder)
    if n_dev > 1:
        from cmacionize_tpu.models.rhd_simulation import ShardedRHDSimulation

        log.status(f"domain decomposition: {n_dev} devices, tiling {tiling}")
        sim = ShardedRHDSimulation.from_params(
            params, tiling=tiling, log=log, seed=seed)
    else:
        sim = RHDSimulation.from_params(params, log=log, seed=seed)
    geometry = sim.geometry
    prefix = params.get_string("DensityGridWriter:prefix", "snapshot_")
    padding = params.get_int("DensityGridWriter:padding", 3)
    folder = params.get_string(
        "RadiationHydrodynamicsSimulation:output folder",
        params.get_string("DensityGridWriter:folder", "."))

    def grid_fields(sim_):
        w = hydro_mod.primitives_from_conserved(sim_.state, sim_.config.gamma)
        return {
            "NumberDensity": np.asarray(w.rho) / constants.PROTON_MASS,
            "Density": np.asarray(w.rho),
            "Velocities": np.stack(
                [np.asarray(w.vx), np.asarray(w.vy), np.asarray(w.vz)],
                axis=-1,
            ),
            "Pressure": np.asarray(w.p),
            "NeutralFractionH": np.asarray(sim_.neutral_fraction),
        }

    def write_numbered(sim_, index):
        name = os.path.join(folder, f"{prefix}{index:0{padding}d}.hdf5")
        write_gadget_snapshot(
            name, geometry, grid_fields(sim_), sim_.time, params=params)
        log.status(f"wrote snapshot {name} (t = {sim_.time:.6g} s)")

    statistics = None
    if params.get_bool(
            "RadiationHydrodynamicsSimulation:output statistics", True):
        from cmacionize_tpu.utils.statistics import StatisticsLogger

        statistics = StatisticsLogger(
            os.path.join(folder, "StatisticsLogger.txt"))
    from cmacionize_tpu.models.trackers import LiveOutputManager

    live_output = LiveOutputManager.from_params(params, geometry, folder)
    # hourly binary checkpoints, like the reference RHD loop (:685-728);
    # --restart <folder> resumes from the latest dump there
    restart_mgr = _restart_manager_from_params(params, default_path=folder)
    if restart_folder:
        from cmacionize_tpu.io.restart import RestartManager

        latest = RestartManager(path=restart_folder).latest()
        if latest is None:
            raise SystemExit(f"no restart file found in {restart_folder}")
        sim.load_restart(latest)
        log.status(f"resumed from {latest} at t = {sim.time:.6g} s")
    else:
        write_numbered(sim, 0)  # initial state (cf. reference snapshot 0)
    sim.run(snapshot_callback=write_numbered, statistics=statistics,
            live_output=live_output, restart_manager=restart_mgr)
    if live_output is not None:
        log.status(f"wrote {len(live_output.written)} live output file(s)")


def _run_rhd_voronoi(params, log, seed, n_dev=1, restart_folder=""):
    """``--rhd`` with ``DensityGrid:type: Voronoi`` — the starbench_voronoi
    mode (the reference plugs VoronoiDensityGrid into the same RHD driver,
    /root/reference/benchmarks/starbench_voronoi.param).  Fixed-dt loop at
    the parameter file's maximum timestep; ``Parallel:`` shards the
    radiation phase via replicated-grid photon DP."""
    import numpy as np

    from cmacionize_tpu import constants
    from cmacionize_tpu.io.gadget import write_gadget_snapshot
    from cmacionize_tpu.models import voronoi
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.voronoi_hydro import VoronoiRHDSimulation

    geometry = GridGeometry.from_params(params)
    rng = np.random.default_rng(
        params.get_int("DensityGrid:VoronoiGeneratorDistribution:random seed",
                       seed))
    generators = voronoi.generators_from_params(params, rng)
    grid = voronoi.build_voronoi_grid(
        geometry, generators,
        num_lloyd=params.get_int(
            "DensityGrid:number of Lloyd iterations", 0))
    log.status(f"Voronoi grid: {grid.n_cells} cells "
               f"(k_max {grid.max_faces})")

    # structured ICs sampled at the generators (BlockSyntax etc.)
    gen_si = (grid.generators * grid.scale + np.asarray(geometry.anchor))
    if params.get_string(
            "DensityFunction:type", "Homogeneous") == "Homogeneous":
        nd0 = params.get_physical_value(
            "DensityFunction:density", "number density", "100. cm^-3")
        T0 = params.get_physical_value(
            "DensityFunction:temperature", "temperature", "8000. K")
    else:
        from cmacionize_tpu.models.density_functions import (
            density_function_from_params,
        )

        df = density_function_from_params(params, geometry)
        _nd = np.asarray(df.number_density)
        _T = np.asarray(df.temperature)
        idx = np.clip(
            ((gen_si - np.asarray(geometry.anchor))
             / np.asarray(geometry.cell_size)).astype(int),
            0, np.asarray(geometry.shape) - 1)
        nd0 = _nd[tuple(idx.T)]
        T0 = _T[tuple(idx.T)]

    total_time = params.get_physical_value(
        "RadiationHydrodynamicsSimulation:total time", "time")
    dt = params.get_physical_value(
        "RadiationHydrodynamicsSimulation:maximum timestep", "time",
        f"{total_time / 256} s")
    n_steps = max(1, int(round(total_time / dt)))
    snap_time = params.get_physical_value(
        "RadiationHydrodynamicsSimulation:snapshot time", "time", "-1. s")
    if snap_time <= 0:
        snap_time = total_time / 10.0
    snap_every = max(1, int(round(snap_time / dt)))

    mesh = None
    if n_dev > 1:
        from cmacionize_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(n_dev, axis_names=("ph",))
        log.status(f"photon data parallelism: {n_dev} devices, "
                   "replicated Voronoi grid (radiation phase)")

    sim = VoronoiRHDSimulation(
        grid,
        gamma=params.get_number(
            "HydroIntegrator:polytropic index", 5.0 / 3.0),
        timestep=dt,
        luminosity=params.get_physical_value(
            "PhotonSourceDistribution:luminosity", "frequency", "1.e48 s^-1"),
        source_position=tuple(params.get_physical_vector(
            "PhotonSourceDistribution:position", "length",
            ["0. m", "0. m", "0. m"])),
        cross_section=params.get_physical_value(
            "CrossSections:hydrogen_0", "surface area", "6.3e-18 cm^2"),
        recombination_rate=params.get_physical_value(
            "RecombinationRates:hydrogen_1", "reaction rate",
            "2.7e-13 cm^3 s^-1"),
        n_photons=params.get_int(
            "RadiationHydrodynamicsSimulation:number of photons", 100000),
        nloop=params.get_int(
            "RadiationHydrodynamicsSimulation:number of iterations", 10),
        number_density=nd0,
        temperature=T0,
        mesh_motion=params.get_bool("DensityGrid:moving mesh", False),
        seed=seed,
        mesh=mesh,
    )

    prefix = params.get_string("DensityGridWriter:prefix", "snapshot_")
    padding = params.get_int("DensityGridWriter:padding", 3)
    folder = params.get_string(
        "RadiationHydrodynamicsSimulation:output folder",
        params.get_string("DensityGridWriter:folder", "."))
    coords = gen_si - np.asarray(geometry.anchor)

    def write_numbered(index):
        from cmacionize_tpu.ops import hydro as hydro_mod  # noqa: F401

        inv_rho = 1.0 / np.maximum(np.asarray(sim.state.rho), 1e-300)
        name = os.path.join(folder, f"{prefix}{index:0{padding}d}.hdf5")
        write_gadget_snapshot(
            name, geometry, {
                "NumberDensity": (
                    np.asarray(sim.state.rho) / constants.PROTON_MASS),
                "Density": np.asarray(sim.state.rho),
                "Velocities": np.stack([
                    np.asarray(sim.state.mom_x) * inv_rho,
                    np.asarray(sim.state.mom_y) * inv_rho,
                    np.asarray(sim.state.mom_z) * inv_rho], axis=-1),
                "NeutralFractionH": np.asarray(sim.neutral_fraction),
                "Volumes": np.asarray(sim.grid.volumes),
            }, sim.time, coordinates=coords, params=params)
        log.status(f"wrote snapshot {name} (t = {sim.time:.6g} s)")

    from cmacionize_tpu.utils import signals

    restart_mgr = _restart_manager_from_params(params, default_path=folder)
    done = 0
    if restart_folder:
        from cmacionize_tpu.io.restart import RestartManager

        latest = RestartManager(path=restart_folder).latest()
        if latest is None:
            raise SystemExit(f"no restart file found in {restart_folder}")
        sim.load_restart(latest)
        done = int(round(sim.time / dt))
        log.status(f"resumed from {latest} at t = {sim.time:.6g} s "
                   f"(step {done})")
    else:
        write_numbered(0)
    signals.install()
    index = done // snap_every + 1
    while done < n_steps:
        chunk = min(snap_every - done % snap_every, n_steps - done)
        sim.run(chunk, log=log.status)
        done += chunk
        if done % snap_every == 0 or done == n_steps:
            write_numbered(index)
            index += 1
        stopping = signals.stop_requested() or restart_mgr.want_stop()
        if restart_mgr.due() or stopping:
            sim.write_restart(restart_mgr)
        if stopping:
            restart_mgr.on_stop()
            log.warning("graceful stop requested; exiting time loop")
            break
    log.status(
        f"ionization front radius {sim.ionization_front_radius():.4g} m "
        f"at t = {sim.time:.6g} s")


def _run_dust(params, log, seed, n_devices_flag=0):
    """Dust-scattering RT producing a CCD image (``--dusty-radiative-transfer``).

    Parameter layout follows the reference's DustSimulation mode
    (/root/reference/src/DustSimulation.cpp:67-176 with
    SpiralGalaxyDensityFunction.hpp:94-106, DustScattering.hpp:96-160,
    CCDImage.hpp:171-196).
    """
    import numpy as _np

    from cmacionize_tpu.models.dust_simulation import DustConfig, DustSimulation
    from cmacionize_tpu.models.grid import GridGeometry

    geometry = GridGeometry.from_params(params)
    band = params.get_string("dust:band", "V")
    band_props = {
        # hgg, pl, albedo, kappa (m^2/kg) — DustScattering.hpp:96-160
        "V": (0.44, 0.43, 0.67, 21.9),
        "K": (0.02, 0.93, 0.28, 2.0),
    }
    if band not in band_props:
        raise ValueError(f"unknown dust band {band!r}")
    hgg, pl_peak, albedo, kappa = band_props[band]

    # SpiralGalaxyDensityFunction: rho = 1.674e-27 * n0 * exp(-w/r - |z|/h)
    n0 = params.get_physical_value(
        "DensityFunction:central density", "number density", "1. cm^-3"
    )
    theta = params.get_physical_value("CCDImage:view theta", "angle", "0. radians")
    phi = params.get_physical_value("CCDImage:view phi", "angle", "0. radians")
    ccd_anchor = (
        params.get_physical_value("CCDImage:anchor x", "length", f"{geometry.anchor[0]} m"),
        params.get_physical_value("CCDImage:anchor y", "length", f"{geometry.anchor[1]} m"),
    )
    ccd_sides = (
        params.get_physical_value("CCDImage:sides x", "length", f"{geometry.sides[0]} m"),
        params.get_physical_value("CCDImage:sides y", "length", f"{geometry.sides[1]} m"),
    )
    config = DustConfig(
        geometry=geometry,
        dust_central_density=kappa * 1.674e-27 * n0,
        dust_scale_radius=params.get_physical_value(
            "DensityFunction:scale length ISM", "length", "6. kpc"
        ),
        dust_scale_height=params.get_physical_value(
            "DensityFunction:scale height ISM", "length", "0.22 kpc"
        ),
        stellar_scale_radius=params.get_physical_value(
            "ContinuousPhotonSource:scale length stars", "length", "5. kpc"
        ),
        stellar_scale_height=params.get_physical_value(
            "ContinuousPhotonSource:scale height stars", "length", "0.6 kpc"
        ),
        bulge_over_total=params.get_number(
            "ContinuousPhotonSource:bulge over total ratio", 0.2),
        n_photons=params.get_int("DustSimulation:number of photons", 500000),
        albedo=albedo,
        hgg=hgg,
        pl=pl_peak,
        ccd_pixels=(
            params.get_int("CCDImage:image width", 200),
            params.get_int("CCDImage:image height", 200),
        ),
        view_theta=theta,
        view_phi=phi,
        ccd_anchor=ccd_anchor,
        ccd_sides=ccd_sides,
        polarization=params.get_bool("DustSimulation:polarization", False),
    )
    sim = DustSimulation(config, log=log, seed=seed)
    folder = params.get_string("DustSimulation:output folder", ".")
    name = params.get_string("CCDImage:filename", "galaxy_image")
    if config.polarization:
        planes = sim.run_polarized()
        for label, plane in planes.items():
            path = os.path.join(folder, f"{name}_{label}.dat")
            _np.asarray(plane, dtype=_np.float64).reshape(
                config.ccd_pixels
            ).tofile(path)
            log.status(f"wrote CCD plane {path}")
    else:
        mesh = None
        n_dev, _tiling = _parallel_config(params, n_devices_flag)
        if n_dev > 1:
            from cmacionize_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(n_dev, axis_names=("ph",))
            log.status(
                f"photon data parallelism: {n_dev} devices (dust RT)")
        image = sim.run(mesh=mesh)
        path = os.path.join(folder, f"{name}.dat")
        # BinaryArray layout: raw row-major doubles (CCDImage.hpp:299-356)
        _np.asarray(image, dtype=_np.float64).tofile(path)
        log.status(f"wrote CCD image {path}")


def _run_emission(params, log, snapshot_file):
    """Emissivity post-processing (``--emission``): read a snapshot, compute
    per-cell line emissivities, write them back into the same file
    (cf. /root/reference/src/EmissivityCalculationSimulation.cpp:59-270)."""
    from cmacionize_tpu.ops.emissivity import emissivity_post_processing

    if not snapshot_file:
        raise SystemExit("--emission requires --file <snapshot.hdf5>")
    emis = emissivity_post_processing(snapshot_file, snapshot_file)
    log.status(
        f"wrote {len(emis)} emissivity datasets back into {snapshot_file}"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="cmacionize-tpu",
        description="Monte Carlo photoionization + RHD framework (JAX)",
    )
    parser.add_argument(
        "--params", "-p", default="",
        help="parameter file (optional for --emission)",
    )
    parser.add_argument("--rhd", action="store_true", help="radiation hydro mode")
    parser.add_argument(
        "--task-based", action="store_true",
        help="accepted for reference CLI parity (same implementation)",
    )
    parser.add_argument(
        "--task-based-rhd", action="store_true",
        help="accepted for reference CLI parity (same implementation)",
    )
    parser.add_argument(
        "--dusty-radiative-transfer", action="store_true",
        help="dust-scattering RT producing a CCD image",
    )
    parser.add_argument(
        "--emission", action="store_true",
        help="emissivity post-processing of an existing snapshot",
    )
    parser.add_argument(
        "--file", default="", help="input snapshot for --emission"
    )
    parser.add_argument(
        "--devices", type=int, default=0,
        help="run domain-decomposed over N devices (overrides Parallel: "
             "block; -1 = all available)",
    )
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument(
        "--memory-log", action="store_true",
        help="write memory.txt + memory_timeline.txt (named allocation "
             "snapshots, cf. the reference's MemoryLogger)",
    )
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument(
        "--dry", action="store_true", help="parse configuration and exit"
    )
    parser.add_argument(
        "--version", action="store_true", help="print the version and exit"
    )
    parser.add_argument(
        "--restart", default="", metavar="FOLDER",
        help="resume an --rhd run from the latest restart dump in FOLDER "
             "(cf. the reference's --restart flag, CMacIonize.cpp:90-91)",
    )
    parser.add_argument(
        "--use-version", default="",
        help="abort unless the running framework version matches exactly "
             "(reproducible remote workflows, cf. the reference's "
             "CMacIonize.cpp:215-227)",
    )
    args = parser.parse_args(argv)

    import cmacionize_tpu as _pkg

    if args.version:
        print(_pkg.__version__)
        return 0
    if args.use_version and args.use_version != _pkg.__version__:
        sys.stderr.write(
            f"version mismatch: running {_pkg.__version__}, "
            f"--use-version requested {args.use_version}\n")
        return 1

    log = TerminalLog("info" if args.verbose else "status")
    if not args.params and not args.emission:
        parser.error("--params is required for this mode")
    params = ParameterFile(args.params) if args.params else ParameterFile(None)
    if args.params:
        log.status(f"loaded parameter file {args.params} "
                   f"(md5: {params.checksum})")

    memory_log = None
    if args.memory_log:
        from cmacionize_tpu.utils.memory import MemoryLogger

        memory_log = MemoryLogger()
        memory_log.snapshot("after parameter parsing")

    t0 = time.time()
    if args.dry:
        log.status("dry run: configuration parsed OK")
        return 0
    import jax

    devices = jax.devices()
    log.status(f"devices: {len(devices)} x {devices[0].platform} "
               f"({devices[0].device_kind})")
    if _writes_gadget_snapshots(args, params):
        from cmacionize_tpu.io.gadget import require_h5py

        require_h5py()
    if args.restart and not (args.rhd or args.task_based_rhd):
        parser.error("--restart is only supported with --rhd")
    if args.rhd or args.task_based_rhd:
        _run_rhd(params, log, args.seed, n_devices_flag=args.devices,
                 restart_folder=args.restart)
    elif args.dusty_radiative_transfer:
        _run_dust(params, log, args.seed, n_devices_flag=args.devices)
    elif args.emission:
        _run_emission(params, log, args.file)
    else:
        _run_ionization(params, log, args.seed, n_devices_flag=args.devices)

    if memory_log is not None:
        memory_log.snapshot("after simulation")
        memory_log.write()
        log.status("memory snapshots → memory.txt, memory_timeline.txt")
    if args.params:
        used = os.path.basename(args.params) + ".used-values"
        params.write_used_values(used)
        log.status(f"used values → {used}")
    log.status(f"total runtime {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
