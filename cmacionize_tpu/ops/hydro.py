"""Finite-volume hydrodynamics: MUSCL-Hancock + HLLC on Cartesian grids.

JAX equivalent of the reference's hydro integrators
(/root/reference/src/HydroIntegrator.hpp:1170-1520 — classic grid — and
/root/reference/src/Hydro.hpp:265-1246 + HydroDensitySubGrid sweeps — the
task-based path).  The reference's per-face jobs and 18-task-per-subgrid DAG
(/root/reference/src/TaskBasedRadiationHydrodynamicsSimulation.cpp:2064-2122)
collapse into a fixed sequence of whole-array stencil passes:

    pad ghosts → limited gradients (3 axes) → half-dt primitive prediction
    → per-axis face reconstruction + HLLC flux → conserved update
    → primitive update

Boundary conditions are applied as ghost-cell paddings
(periodic/reflective/inflow/outflow, cf. the boundary enum at
/root/reference/src/HydroIntegrator.hpp:139-152).

All functions are pure; state is a NamedTuple pytree of [nx,ny,nz] arrays.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from cmacionize_tpu.ops import riemann

GAMMA_DEFAULT = 5.0 / 3.0

# pressure/density floors (the reference's SAFE_HYDRO guards)
RHO_FLOOR = 1e-30
P_FLOOR = 1e-30


class HydroState(NamedTuple):
    """Conserved state per unit volume: mass, momentum, total energy density."""

    rho: jnp.ndarray
    mom_x: jnp.ndarray
    mom_y: jnp.ndarray
    mom_z: jnp.ndarray
    energy: jnp.ndarray


class Primitives(NamedTuple):
    rho: jnp.ndarray
    vx: jnp.ndarray
    vy: jnp.ndarray
    vz: jnp.ndarray
    p: jnp.ndarray


def conserved_from_primitives(w: Primitives, gamma: float = GAMMA_DEFAULT) -> HydroState:
    kinetic = 0.5 * w.rho * (w.vx**2 + w.vy**2 + w.vz**2)
    return HydroState(
        rho=w.rho,
        mom_x=w.rho * w.vx,
        mom_y=w.rho * w.vy,
        mom_z=w.rho * w.vz,
        energy=w.p / (gamma - 1.0) + kinetic,
    )


def primitives_from_conserved(u: HydroState, gamma: float = GAMMA_DEFAULT) -> Primitives:
    rho = jnp.maximum(u.rho, RHO_FLOOR)
    vx = u.mom_x / rho
    vy = u.mom_y / rho
    vz = u.mom_z / rho
    kinetic = 0.5 * rho * (vx**2 + vy**2 + vz**2)
    p = jnp.maximum((gamma - 1.0) * (u.energy - kinetic), P_FLOOR)
    return Primitives(rho, vx, vy, vz, p)


# ---------------------------------------------------------------- boundaries

# boundary condition codes per (axis, side)
BC_PERIODIC = "periodic"
BC_REFLECTIVE = "reflective"
BC_OUTFLOW = "outflow"
BC_INFLOW = "inflow"  # fixed ghost state, provided via inflow_state


def _pad_axis(
    arr, axis, bc_lo, bc_hi, n=2, flip_sign=False,
    inflow_lo=None, inflow_hi=None,
):
    """Pad one axis with n ghost cells per side according to the BCs.

    Inflow ghost values may be scalars or full ghost-shaped arrays
    ([n, ...] along the padded axis) — the latter supports spatially-varying
    boundary profiles like the Bondi inflow
    (cf. BondiHydroBoundary, /root/reference/src/HydroBoundary.hpp).
    """

    lo = ghost_one_side(arr, axis, "lo", bc_lo, n, flip_sign, inflow_lo)
    hi = ghost_one_side(arr, axis, "hi", bc_hi, n, flip_sign, inflow_hi)
    return jnp.concatenate([lo, arr, hi], axis=axis)


def ghost_one_side(a, axis, side, bc, n=2, flip_sign=False, inflow_value=None):
    """Ghost-cell slab for one side of one axis (used by both the local
    padding above and the domain-decomposed halo exchange, which needs the
    physical-boundary ghosts separately from the neighbor halos)."""
    idx = [slice(None)] * a.ndim
    if bc == BC_PERIODIC:
        idx[axis] = slice(-n, None) if side == "lo" else slice(0, n)
        ghost = a[tuple(idx)]
    elif bc == BC_REFLECTIVE:
        idx[axis] = slice(0, n) if side == "lo" else slice(-n, None)
        ghost = jnp.flip(a[tuple(idx)], axis=axis)
        if flip_sign:
            ghost = -ghost
    elif bc == BC_OUTFLOW:
        idx[axis] = slice(0, 1) if side == "lo" else slice(-1, None)
        edge = a[tuple(idx)]
        reps = [1] * a.ndim
        reps[axis] = n
        ghost = jnp.tile(edge, reps)
    elif bc == BC_INFLOW:
        shape = list(a.shape)
        shape[axis] = n
        ghost = jnp.broadcast_to(jnp.asarray(inflow_value, a.dtype), shape)
    else:
        raise ValueError(f"unknown boundary condition {bc!r}")
    return ghost


def pad_primitives(
    w: Primitives,
    boundaries,
    n: int = 2,
    inflow_states: Optional[dict] = None,
) -> Primitives:
    """Pad all three axes with ghost cells.

    ``boundaries``: ((bc_x_lo, bc_x_hi), (bc_y_lo, bc_y_hi), (bc_z_lo, bc_z_hi)).
    ``inflow_states``: {(axis, "lo"|"hi"): 5-tuple of scalar or ghost-shaped
    arrays (rho, vx, vy, vz, p)}.
    """
    fields = list(w)
    normal = {0: 1, 1: 2, 2: 3}  # field index of the normal velocity per axis
    for axis in range(3):
        bc_lo, bc_hi = boundaries[axis]
        for i, field in enumerate(fields):
            lo_val = hi_val = None
            if inflow_states is not None:
                state_lo = inflow_states.get((axis, "lo"))
                state_hi = inflow_states.get((axis, "hi"))
                if state_lo is not None:
                    lo_val = state_lo[i]
                if state_hi is not None:
                    hi_val = state_hi[i]
            fields[i] = _pad_axis(
                field,
                axis,
                bc_lo,
                bc_hi,
                n=n,
                flip_sign=(i == normal[axis]),
                inflow_lo=lo_val,
                inflow_hi=hi_val,
            )
    return Primitives(*fields)


# ----------------------------------------------------------------- gradients


def _limited_slope(w_m, w_0, w_p):
    """Monotonized-central limited difference per cell (in units of one cell).

    Plays the role of the reference's per-face pair limiter + slope limiter
    combination (/root/reference/src/Hydro.hpp:108, GradientCalculator.hpp):
    slopes never create new extrema between neighbors.
    """
    dl = w_0 - w_m
    dr = w_p - w_0
    dc = 0.5 * (w_p - w_m)
    slope = jnp.sign(dc) * jnp.minimum(
        jnp.abs(dc), 2.0 * jnp.minimum(jnp.abs(dl), jnp.abs(dr))
    )
    return jnp.where(dl * dr > 0.0, slope, 0.0)


def _shift(arr, axis, offset):
    """Slice a ±1 shifted pad-1 window along `axis` (offset ∈ {-1, 0, +1})."""
    idx = [slice(None)] * arr.ndim
    if offset == 1:
        idx[axis] = slice(2, None)
    elif offset == -1:
        idx[axis] = slice(0, -2)
    else:
        idx[axis] = slice(1, -1)
    return arr[tuple(idx)]


def limited_gradients(wp: Primitives):
    """Per-axis limited differences of each primitive on the padded array.

    Input: padded primitives (each axis +2).  Output: for each axis, a
    Primitives of slopes valid on the pad-1 interior region.
    """
    grads = []
    for axis in range(3):
        slopes = []
        for field in wp:
            # crop the other axes to the pad-1 region, diff along `axis`
            w_m = field
            for a in range(3):
                if a == axis:
                    continue
                sl = [slice(None)] * 3
                sl[a] = slice(1, -1)
                w_m = w_m[tuple(sl)]
            w_minus = _shift(w_m, axis, -1)
            w_0 = _shift(w_m, axis, 0)
            w_plus = _shift(w_m, axis, 1)
            slopes.append(_limited_slope(w_minus, w_0, w_plus))
        grads.append(Primitives(*slopes))
    return grads


def _crop1(field):
    return field[1:-1, 1:-1, 1:-1]


def predict_half_step(
    wp1: Primitives, grads, dt: float, cell_size, gamma: float
) -> Primitives:
    """Half-dt primitive prediction (MUSCL-Hancock predictor).

    Primitive-form Euler equations, cf. the reference's
    `predict_primitive_variables` (/root/reference/src/Hydro.hpp:265 region,
    HydroIntegrator.hpp:1199-1269):
        ρ' = ρ - dt/2 (v·∇ρ + ρ ∇·v)
        v' = v - dt/2 (v·∇v + ∇P/ρ)
        P' = P - dt/2 (v·∇P + γP ∇·v)
    """
    gx, gy, gz = grads  # slopes per cell width on the pad-1 region
    inv = [1.0 / float(cell_size[a]) for a in range(3)]
    rho, vx, vy, vz, p = wp1
    half = 0.5 * dt

    drho = (
        vx * gx.rho * inv[0] + vy * gy.rho * inv[1] + vz * gz.rho * inv[2]
        + rho * (gx.vx * inv[0] + gy.vy * inv[1] + gz.vz * inv[2])
    )
    dvx = (
        vx * gx.vx * inv[0] + vy * gy.vx * inv[1] + vz * gz.vx * inv[2]
        + gx.p * inv[0] / rho
    )
    dvy = (
        vx * gx.vy * inv[0] + vy * gy.vy * inv[1] + vz * gz.vy * inv[2]
        + gy.p * inv[1] / rho
    )
    dvz = (
        vx * gx.vz * inv[0] + vy * gy.vz * inv[1] + vz * gz.vz * inv[2]
        + gz.p * inv[2] / rho
    )
    dp = (
        vx * gx.p * inv[0] + vy * gy.p * inv[1] + vz * gz.p * inv[2]
        + gamma * p * (gx.vx * inv[0] + gy.vy * inv[1] + gz.vz * inv[2])
    )
    return Primitives(
        jnp.maximum(rho - half * drho, RHO_FLOOR),
        vx - half * dvx,
        vy - half * dvy,
        vz - half * dvz,
        jnp.maximum(p - half * dp, P_FLOOR),
    )


def _axis_faces(w: Primitives, slopes: Primitives, axis: int):
    """Left/right states at the faces along `axis` (N+1 faces from N+2 cells)."""

    def lo(f, s):
        idx = [slice(None)] * 3
        idx[axis] = slice(0, -1)
        return f[tuple(idx)] + 0.5 * s[tuple(idx)]

    def hi(f, s):
        idx = [slice(None)] * 3
        idx[axis] = slice(1, None)
        return f[tuple(idx)] - 0.5 * s[tuple(idx)]

    left = Primitives(*(lo(f, s) for f, s in zip(w, slopes)))
    right = Primitives(*(hi(f, s) for f, s in zip(w, slopes)))
    return left, right


_VEL_PERM = {
    # (normal, tangential1, tangential2) velocity field order per axis
    0: (1, 2, 3),
    1: (2, 3, 1),
    2: (3, 1, 2),
}


def _face_flux(left: Primitives, right: Primitives, axis: int, gamma: float,
               solver: str = "HLLC"):
    """Interface flux at the faces along `axis`, rotated back to (x,y,z)
    order.  ``solver`` selects HLLC or the exact Riemann solver, like the
    reference's RiemannSolverFactory
    (/root/reference/src/RiemannSolverFactory.hpp:54-57).

    Returns a 5-tuple (mass, mom_x, mom_y, mom_z, energy) flux arrays.
    """
    n, t1, t2 = _VEL_PERM[axis]
    flux_fn = {"HLLC": riemann.hllc_flux, "Exact": riemann.exact_flux}[solver]
    flux = flux_fn(
        left[0], left[n], left[t1], left[t2], left[4],
        right[0], right[n], right[t1], right[t2], right[4],
        gamma=gamma,
    )
    mom = [None, None, None]
    mom[n - 1] = flux.mom_n
    mom[t1 - 1] = flux.mom_t1
    mom[t2 - 1] = flux.mom_t2
    return (flux.mass, mom[0], mom[1], mom[2], flux.energy)


@functools.partial(
    jax.jit,
    static_argnames=("boundaries", "cell_size", "gamma", "riemann_solver"),
)
def hydro_step(
    u: HydroState,
    dt,
    *,
    boundaries,
    cell_size: Tuple[float, float, float],
    gamma: float = GAMMA_DEFAULT,
    riemann_solver: str = "HLLC",
    gravity=None,
    inflow_states: Optional[dict] = None,
) -> HydroState:
    """One MUSCL-Hancock step: U^{n+1} = U^n - dt ∇·F + dt S.

    ``gravity``: optional (gx, gy, gz) acceleration fields for the source
    term (applied kick + energy work, cf. HydroIntegrator.hpp:1341-1380).
    """
    w = primitives_from_conserved(u, gamma)
    wp = pad_primitives(w, boundaries, n=2, inflow_states=inflow_states)
    return hydro_step_padded(
        u, wp, dt, cell_size=cell_size, gamma=gamma, gravity=gravity,
        riemann_solver=riemann_solver,
    )


def hydro_step_padded(
    u: HydroState,
    wp: Primitives,
    dt,
    *,
    cell_size: Tuple[int, int, int],
    gamma: float = GAMMA_DEFAULT,
    gravity=None,
    riemann_solver: str = "HLLC",
) -> HydroState:
    """MUSCL-Hancock update from pre-padded primitives (2 ghosts per side).

    Split out of :func:`hydro_step` so the domain-decomposed path can supply
    ghost cells via an ICI halo exchange (``ppermute`` of slab faces) instead
    of local boundary-condition padding — the JAX equivalent of the
    reference's pairwise neighbor sweeps
    (`HydroDensitySubGrid::outer_gradient_sweep` /`outer_flux_sweep`,
    /root/reference/src/HydroDensitySubGrid.hpp:626,351).
    """
    grads = limited_gradients(wp)  # pad-1 region
    wp1 = Primitives(*(f[1:-1, 1:-1, 1:-1] for f in wp))
    w_pred = predict_half_step(wp1, grads, dt, cell_size, gamma)

    new_fields = list(u)
    for axis in range(3):
        left, right = _axis_faces(w_pred, grads[axis], axis)
        fluxes = _face_flux(left, right, axis, gamma, riemann_solver)
        inv_dx = 1.0 / float(cell_size[axis])
        for i in range(5):
            f = fluxes[i]
            # crop the other (padded) axes to the domain, diff along `axis`
            for a in range(3):
                if a != axis:
                    sl = [slice(None)] * 3
                    sl[a] = slice(1, -1)
                    f = f[tuple(sl)]
            lo_idx = [slice(None)] * 3
            hi_idx = [slice(None)] * 3
            lo_idx[axis] = slice(0, -1)
            hi_idx[axis] = slice(1, None)
            div = (f[tuple(hi_idx)] - f[tuple(lo_idx)]) * inv_dx
            new_fields[i] = new_fields[i] - dt * div

    out = HydroState(*new_fields)
    if gravity is not None:
        gx, gy, gz = gravity
        rho = u.rho
        out = out._replace(
            mom_x=out.mom_x + dt * rho * gx,
            mom_y=out.mom_y + dt * rho * gy,
            mom_z=out.mom_z + dt * rho * gz,
            energy=out.energy
            + dt * (u.mom_x * gx + u.mom_y * gy + u.mom_z * gz),
        )
    # enforce positivity (SAFE_HYDRO)
    out = out._replace(rho=jnp.maximum(out.rho, RHO_FLOOR))
    return out


def cfl_timestep(
    u: HydroState,
    cell_size,
    cfl: float = 0.2,
    gamma: float = GAMMA_DEFAULT,
):
    """CFL-limited timestep (cf. HydroIntegrator::get_maximal_timestep,
    /root/reference/src/HydroIntegrator.hpp:1136)."""
    w = primitives_from_conserved(u, gamma)
    cs = jnp.sqrt(gamma * w.p / w.rho)
    dt_axes = [
        float(cell_size[a]) / (jnp.abs((w.vx, w.vy, w.vz)[a]) + cs)
        for a in range(3)
    ]
    return cfl * jnp.min(jnp.minimum(dt_axes[0], jnp.minimum(dt_axes[1], dt_axes[2])))


# ----------------------------------------------------------- isothermal mode


def isothermal_hydro_step(
    u: HydroState,
    dt,
    *,
    sound_speed: float,
    boundaries,
    cell_size,
    gravity=None,
    inflow_states: Optional[dict] = None,
    gamma_eff: float = 1.0 + 1e-6,
) -> HydroState:
    """Isothermal (γ = 1) step: P = c_s² ρ enforced before and after.

    The reference's γ == 1 mode ignores the energy equation entirely
    (/root/reference/src/HydroIntegrator.hpp:283-292); here the step runs
    with γ_eff = 1 + ε (sound speed reduces to c_s) and the energy is reset
    from the isothermal EOS afterwards.
    """
    w = primitives_from_conserved(u, gamma_eff)
    w = w._replace(p=sound_speed**2 * w.rho)
    u = conserved_from_primitives(w, gamma_eff)
    u = hydro_step(
        u, dt,
        boundaries=boundaries, cell_size=cell_size, gamma=gamma_eff,
        gravity=gravity, inflow_states=inflow_states,
    )
    w = primitives_from_conserved(u, gamma_eff)
    w = w._replace(p=sound_speed**2 * w.rho)
    return conserved_from_primitives(w, gamma_eff)


def two_temperature_coupling(
    u: HydroState,
    neutral_fraction,
    *,
    gamma: float,
    ionised_temperature: float = 1.0e4,
    neutral_temperature: float = 100.0,
    shock_temperature: float = 3.0e4,
    radiative_heating: bool = True,
    radiative_cooling: bool = False,
) -> HydroState:
    """Ionization → gas-energy coupling (HydroIntegrator.hpp:1288-1339):
    ionized gas is driven to T_ion, neutral gas to T_neutral, shock-heated
    gas (T > T_shock) is left alone.  Pure per-cell function — shared by the
    single-device and domain-decomposed RHD drivers."""
    from cmacionize_tpu import constants

    xH = neutral_fraction
    w = primitives_from_conserved(u, gamma)

    k_over_mp = constants.BOLTZMANN / constants.PROTON_MASS
    T_target = (
        ionised_temperature * (1.0 - xH) + neutral_temperature * xH
    )
    # current gas temperature with mean-particle-mass correction
    T_old = 0.5 * (1.0 + xH) * w.p / (w.rho * k_over_mp)
    shock_heated = T_old > shock_temperature

    ufac = 2.0 * k_over_mp / ((gamma - 1.0) * (1.0 + xH))
    u_target = ufac * T_target
    u_old = w.p / ((gamma - 1.0) * w.rho)
    du = u_target - u_old
    dE = w.rho * du  # per unit volume

    delta = jnp.zeros_like(dE)
    if radiative_heating:
        delta = jnp.where(dE > 0.0, dE, delta)
    if radiative_cooling:
        dE_lim = jnp.maximum(
            dE,
            2.0 * ufac
            * (neutral_temperature - ionised_temperature) * w.rho,
        )
        # factor 1/2 for the mean-particle-mass change (reference :1330)
        delta = jnp.where(dE < 0.0, 0.5 * dE_lim, delta)
    delta = jnp.where(shock_heated, 0.0, delta)
    return u._replace(energy=u.energy + delta)


def apply_hydro_mask(u: HydroState, mask, u_masked: HydroState) -> HydroState:
    """Reset the state inside ``mask`` to fixed values.

    Equivalent of the reference's HydroMask application
    (BlockSyntaxHydroMask / RescaledICHydroMask,
    /root/reference/src/HydroMaskFactory.hpp:68-73): regions (e.g. the
    divergent center of a Bondi setup) are overwritten after every step.
    """
    return HydroState(*(
        jnp.where(mask, masked_field, field)
        for field, masked_field in zip(u, u_masked)
    ))


# ---------------------------------------------------------------------------
# Internal hydro units
# ---------------------------------------------------------------------------


class InternalHydroUnits(NamedTuple):
    """Round-off-minimizing unit system for the f32 hydro state.

    JAX equivalent of the reference's src/InternalHydroUnits.hpp:100-180:
    length/mass/time units derived from the box size, mean density and mean
    pressure put the working arrays at O(1), where f32 has its ~1e-7
    relative precision — essential for deep-contrast problems (bondi).
    All factors are exact scalar multiplications, so conversion itself adds
    at most 1 ulp.
    """

    length: float  # m per internal length
    density: float  # kg m^-3 per internal density
    pressure: float  # Pa per internal pressure
    velocity: float
    time: float
    momentum_density: float
    energy_density: float

    @classmethod
    def from_state(cls, u: "HydroState", box_size: float,
                   gamma: float = GAMMA_DEFAULT) -> "InternalHydroUnits":
        w = primitives_from_conserved(u, gamma)
        return cls.from_averages(
            box_size,
            float(jnp.mean(w.rho)),
            float(jnp.mean(w.p)),
        )

    @classmethod
    def from_averages(cls, box_size: float, mean_density: float,
                      mean_pressure: float) -> "InternalHydroUnits":
        L = float(box_size)
        M = float(mean_density) * L ** 3
        T = float(M / (mean_pressure * L)) ** 0.5
        return cls(
            length=L,
            density=mean_density,
            pressure=float(mean_pressure),
            velocity=L / T,
            time=T,
            momentum_density=mean_density * L / T,
            energy_density=float(mean_pressure),
        )

    def to_internal(self, u: "HydroState") -> "HydroState":
        return HydroState(
            rho=u.rho / self.density,
            mom_x=u.mom_x / self.momentum_density,
            mom_y=u.mom_y / self.momentum_density,
            mom_z=u.mom_z / self.momentum_density,
            energy=u.energy / self.energy_density,
        )

    def to_si(self, u: "HydroState") -> "HydroState":
        return HydroState(
            rho=u.rho * self.density,
            mom_x=u.mom_x * self.momentum_density,
            mom_y=u.mom_y * self.momentum_density,
            mom_z=u.mom_z * self.momentum_density,
            energy=u.energy * self.energy_density,
        )


def hydro_step_internal(
    u: HydroState,
    dt,
    units: InternalHydroUnits,
    *,
    boundaries,
    cell_size,
    gamma: float = GAMMA_DEFAULT,
    riemann_solver: str = "HLLC",
    gravity=None,
    inflow_states: Optional[dict] = None,
) -> HydroState:
    """hydro_step computed in the internal unit system (SI in, SI out)."""
    ui = units.to_internal(u)
    accel = units.velocity / units.time
    grav_i = None
    if gravity is not None:
        grav_i = tuple(g / accel for g in gravity)
    inflow_i = None
    if inflow_states is not None:
        inflow_i = {
            k: Primitives(
                rho=v.rho / units.density,
                vx=v.vx / units.velocity,
                vy=v.vy / units.velocity,
                vz=v.vz / units.velocity,
                p=v.p / units.pressure,
            )
            for k, v in inflow_states.items()
        }
    ui = hydro_step(
        ui, dt / units.time,
        boundaries=boundaries,
        cell_size=tuple(float(c) / units.length for c in cell_size),
        gamma=gamma, riemann_solver=riemann_solver,
        gravity=grav_i, inflow_states=inflow_i,
    )
    return units.to_si(ui)
