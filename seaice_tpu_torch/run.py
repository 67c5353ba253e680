"""Standalone run loop.

The port of the JAX package's `run.py`, the reference core's lifecycle
(`mpas_seaice_core.F`: seaice_core_init :34, seaice_core_run :257 with
its timeLoop :314-371, seaice_core_finalize :414): a host loop that
advances the clock, interpolates the forcing records on the host
(float64, then cast to the model dtype), hands them to the device in one
copy, derives the atmospheric forcing there from the ice state of that
step, steps the model, checks the state, and serves the output and
restart alarms.

The JAX package jits the per-step device program; here it runs eager on
the card.  The host waits for the card once per step (as the JAX loop
does, `jax.block_until_ready`), and fetches the state-check flags once
every `check_interval` steps, in one copy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from .column.driver import AtmosForcing, OceanForcing, slab_ocean_frzmlt
from .column.orbital import compute_coszen
from .diagnostics import PhaseTimers, check_state
from .dynamics.evp import DynamicsForcing
from .error import raise_on_failed_checks
from .forcing.clock import Alarm, ModelClock
from .forcing.core import (CoreAtmosForcing, NcarOceanForcing,
                           derive_atmos_fields)
from .io.checkpoint import save_checkpoint, write_restart_timestamp
from .utils.containers import upload


@dataclasses.dataclass
class RunStreams:
    """The runner's output and restart streams.  output: an
    `io.OutputStream` (the sharded runner's: an `io.ShardedOutputStream`)
    or None."""
    output: Optional[Any] = None
    output_interval: float = 86400.0
    restart_dir: Optional[str] = None
    restart_interval: float = 5 * 86400.0


def restore_clock(clock: ModelClock, alarms, clock_metadata):
    """Set the clock from a checkpoint's clock metadata ("year",
    "seconds") and the alarms to the period they were in at that time,
    as a run that had gone straight on would have them."""
    clock.year = int(np.asarray(clock_metadata.get("year", clock.year)))
    clock.seconds = float(np.asarray(clock_metadata["seconds"]))
    for alarm in alarms:
        alarm.is_ringing(clock)


def derived_forcing(atm_raw, ocn_raw, aice, dt_step, use_column):
    """The dynamics forcing and, with the column package, the column's
    AtmosForcing and OceanForcing (with the slab ocean's frzmlt), from
    the derived atmospheric fields and the raw ocean records (dicts of
    cell tensors, or None); a field the records lack takes the JAX
    runner's default."""
    def full(value):
        return torch.full_like(aice, value)

    def g(src, k, default=0.0):
        return full(default) if src is None or k not in src else src[k]

    dyn = DynamicsForcing(
        u_air_velocity=g(atm_raw, "u_air"),
        v_air_velocity=g(atm_raw, "v_air"),
        air_density=full(1.3),
        u_ocean_velocity=g(ocn_raw, "uOceanVelocity"),
        v_ocean_velocity=g(ocn_raw, "vOceanVelocity"),
        sea_surface_tilt_u=g(ocn_raw, "seaSurfaceTiltU"),
        sea_surface_tilt_v=g(ocn_raw, "seaSurfaceTiltV"),
        land_ice_mask=full(0.0))
    if not (use_column and atm_raw is not None):
        return dyn, None, None
    atmf = AtmosForcing(
        air_temperature=g(atm_raw, "air_temperature", 253.0),
        specific_humidity=g(atm_raw, "specific_humidity", 0.0005),
        u_air=g(atm_raw, "u_air"), v_air=g(atm_raw, "v_air"),
        longwave_down=g(atm_raw, "longwave_down", 180.0),
        sw_vis_dir=g(atm_raw, "sw_vis_dir"),
        sw_vis_dif=g(atm_raw, "sw_vis_dif"),
        sw_ir_dir=g(atm_raw, "sw_ir_dir"),
        sw_ir_dif=g(atm_raw, "sw_ir_dif"),
        rain_rate=g(atm_raw, "rain_rate"),
        snow_rate=g(atm_raw, "snow_rate"),
        air_density=full(1.3),
        air_level_height=full(10.0))
    sst = g(ocn_raw, "seaSurfaceTemperature", -1.8)
    Tf = g(ocn_raw, "seaFreezingTemperature", -1.8)
    hmix = g(ocn_raw, "oceanMixedLayerDepth", 20.0)
    ocnf = OceanForcing(
        sst=sst, sss=g(ocn_raw, "seaSurfaceSalinity", 34.0),
        freezing_temperature=Tf,
        frzmlt=slab_ocean_frzmlt(sst, Tf, hmix, dt_step),
        mixed_layer_depth=hmix)
    return dyn, atmf, ocnf


def step_inputs(state, sixh, monthly, ocn_raw, lon, lat, seconds_today,
                day_of_year, dt_step, use_column):
    """The step's forcing from the raw records and the CURRENT ice state
    (reference derived-forcing semantics, mpas_seaice_forcing.F:
    842-1190): the aggregate ice area and surface temperature of the
    state before the step feed the Rosati-Miyakoda longwave; the solar
    zenith angle comes from the clock.  Returns (DynamicsForcing,
    AtmosForcing or None, OceanForcing or None, coszen or None)."""
    aicen = state.tracers["iceAreaCategory"]
    aice = aicen.sum(-1)
    atm_raw = coszen = None
    if sixh is not None:
        tsfc_tr = state.tracers.get("surfaceTemperature")
        if tsfc_tr is not None:
            tsfc = torch.where(
                aice > 1e-11,
                (tsfc_tr * aicen).sum(-1) / aice.clamp(min=1e-11), 0.0)
        else:
            tsfc = torch.zeros_like(aice)
        sst0 = (ocn_raw or {}).get("seaSurfaceTemperature",
                                   torch.full_like(aice, -1.8))
        atm_raw = derive_atmos_fields(sixh, monthly, lon, lat, aice, tsfc,
                                      sst0, seconds_today, day_of_year)
        coszen, _ = compute_coszen(lat, lon, day_of_year, seconds_today)
    dyn, atmf, ocnf = derived_forcing(atm_raw, ocn_raw, aice, dt_step,
                                      use_column)
    return dyn, atmf, ocnf, coszen


def _wait(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def state_checks(state, diags):
    """The state check of one step's result and its column warning
    masks, on the device: (checks, cell_masks).  Column warnings join
    the abort gate with per-cell attribution (reference ice_warnings.F90
    and the cell dump at mpas_seaice_column.F:1872-1939)."""
    checks = check_state(state)
    cell_masks = {}
    fl = diags.get("column_fluxes")
    if fl is not None and getattr(fl, "warnings", None):
        for name, mask in fl.warnings.items():
            key = "column_" + name
            ok = ~mask.any()
            checks[key] = ok
            checks["ok"] = checks["ok"] & ok
            cell_masks[key] = mask
    return checks, cell_masks


class _TimeLoop:
    """The time loop both runners share (reference timeLoop :314-371):
    the forcing records on the device, the device step, the clock, the
    abort gate every `check_interval` steps, the analysis members on their
    own alarms (reference timeLoop :321-331), and the output and restart
    alarms.  A runner supplies `_to_device` (the records and the clock
    scalars, in one copy), `_advance` (the step and its state check),
    `_abort_gate`, `_analyse`, `_write_output` and `_write_restart`."""

    def __init__(self, model, state, atmos_forcing, ocean_forcing, clock,
                 streams, analysis=None):
        self.model = model
        self.state = state
        self.atmos = atmos_forcing
        self.ocean = ocean_forcing
        self.clock = clock or ModelClock(calendar=model.cfg.run.calendar)
        self.streams = streams or RunStreams()
        self.analysis = analysis
        self.step_fn = model.make_step()
        self.timers = PhaseTimers()
        self._out_alarm = Alarm(self.streams.output_interval)
        self._restart_alarm = Alarm(self.streams.restart_interval)
        self.dtype = model.dtype
        self.device = model.device
        self.diags = None            # the last step's diagnostics

    def restore_clock(self, clock_metadata):
        """Continue from a checkpoint's clock metadata (the alarms as a
        straight run would have them)."""
        restore_clock(self.clock, (self._out_alarm, self._restart_alarm),
                      clock_metadata)

    def _raw_forcing(self):
        """The records at the clock's time and the clock's scalars, on
        the device in the model dtype, in one copy: (sixh, monthly,
        ocn_raw, seconds_today, day_of_year)."""
        groups = []
        if self.atmos is not None:
            groups += list(self.atmos.raw_snapshot(self.clock))
        if self.ocean is not None:
            groups.append(self.ocean.snapshot(self.clock))
        dicts, scalars = self._to_device(
            groups, (self.clock.seconds_today, self.clock.day_of_year))
        sixh = monthly = ocn_raw = None
        if self.atmos is not None:
            sixh, monthly = dicts[0], dicts[1]
        if self.ocean is not None:
            ocn_raw = dicts[-1]
        return (sixh, monthly, ocn_raw, *scalars)

    def run(self, n_steps: int, check_interval: int = 1):
        """check_interval: steps between host-side abort-gate fetches
        (the state check itself runs on the device every step, like the
        reference's per-step seaice_check_state)."""
        for istep in range(n_steps):
            with self.timers.time("forcing"):
                raw = self._raw_forcing()
            with self.timers.time("timestep"):
                checks, cell_masks = self._advance(raw)
                _wait(self.device)
            self.clock.advance(self.model.cfg.run.dt)

            if (istep + 1) % check_interval == 0:
                with self.timers.time("state_check"):
                    self._abort_gate(checks, cell_masks)

            if self.analysis is not None:
                with self.timers.time("analysis"):
                    self._analyse()

            if self.streams.output is not None and \
                    self._out_alarm.is_ringing(self.clock):
                with self.timers.time("output"):
                    self._write_output()
            if self.streams.restart_dir is not None and \
                    self._restart_alarm.is_ringing(self.clock):
                with self.timers.time("restart_write"):
                    self._write_restart()
        return self.state


class StandaloneRunner(_TimeLoop):
    """Owns the clock + forcing + model; `run(n_steps)` is the time
    loop.  analysis: an `analysis.AnalysisDriver` whose members run on
    their own alarms after every step, or None."""

    def __init__(self, model, state,
                 atmos_forcing: Optional[CoreAtmosForcing] = None,
                 ocean_forcing: Optional[NcarOceanForcing] = None,
                 clock: Optional[ModelClock] = None,
                 streams: Optional[RunStreams] = None,
                 analysis=None):
        super().__init__(model, state, atmos_forcing, ocean_forcing, clock,
                         streams, analysis)
        if analysis is not None:
            analysis.bootstrap(model, state)
            analysis.init(model, state)
        self._lon = self._lat = None
        if self.atmos is not None:
            self._lon, self._lat = upload([self.atmos.lon, self.atmos.lat],
                                          self.dtype, self.device)
        self._device_step = self._build_device_step()

    def next_step_inputs(self):
        """The forcing the next step would take, from the current state
        and clock, without advancing: (DynamicsForcing, AtmosForcing or
        None, OceanForcing or None, coszen or None)."""
        sixh, monthly, ocn_raw, seconds, doy = self._raw_forcing()
        return step_inputs(self.state, sixh, monthly, ocn_raw, self._lon,
                           self._lat, seconds, doy, self.model.cfg.run.dt,
                           self.model.cfg.column.use_column_package)

    def _build_device_step(self):
        """The work of one coupling step on the device: derived forcing
        from the CURRENT ice state, zenith angles, the model step, the
        state check and the column warning masks.  Returns
        fn(tensors, state, sixh, monthly, ocn_raw, seconds_today,
        day_of_year) -> (state, diags, checks, cell_masks)."""
        model = self.model
        dt_step = model.cfg.run.dt
        use_col = model.cfg.column.use_column_package
        step_fn = self.step_fn
        lon, lat = self._lon, self._lat

        def fn(tensors, state, sixh, monthly, ocn_raw, seconds_today,
               day_of_year):
            dyn, atmf, ocnf, coszen = step_inputs(
                state, sixh, monthly, ocn_raw, lon, lat, seconds_today,
                day_of_year, dt_step, use_col)
            state, diags = step_fn(tensors, state, dyn, atmf, ocnf,
                                   coszen=coszen, day_of_year=day_of_year,
                                   lat=lat)
            return (state, diags, *state_checks(state, diags))

        return fn

    def _to_device(self, groups, scalars):
        arrays = [v for g in groups for v in g.values()]
        views = iter(upload(arrays + [np.float64(x) for x in scalars],
                            self.dtype, self.device))
        return [{k: next(views) for k in g} for g in groups], list(views)

    def _advance(self, raw):
        self.state, self.diags, checks, cell_masks = self._device_step(
            self.model.tensors, self.state, *raw)
        return checks, cell_masks

    def _abort_gate(self, checks, cell_masks):
        raise_on_failed_checks(checks, self.state, self.clock.timestamp(),
                               run_dir=self.streams.restart_dir,
                               cell_masks=cell_masks)

    def _analyse(self):
        self.analysis.on_timestep(self.model, self.state, self.clock,
                                  self.diags)

    def _write_output(self):
        tr = self.state.tracers
        fields = {
            "iceAreaCell": tr["iceAreaCategory"].sum(-1),
            "iceVolumeCell": tr["iceVolumeCategory"].sum(-1),
            "snowVolumeCell": tr["snowVolumeCategory"].sum(-1),
            "uVelocity": self.state.velocity.u_velocity,
            "vVelocity": self.state.velocity.v_velocity,
        }
        self.streams.output.write(
            {k: v.cpu().numpy() for k, v in fields.items()},
            self.clock.timestamp())

    def _write_restart(self):
        ts = self.clock.timestamp()
        path = os.path.join(self.streams.restart_dir, f"restart.{ts}.npz")
        save_checkpoint(path, self.state, {
            "year": self.clock.year, "seconds": self.clock.seconds})
        write_restart_timestamp(self.streams.restart_dir, ts)


class ShardedStandaloneRunner(_TimeLoop):
    """The standalone time loop over a ShardedSeaIceModel: the global
    forcing records are interpolated on the host and the RAW records
    scattered to the blocks (`part.scatter_cell_field`, one copy to the
    device for all blocks); everything derived (longwave and shortwave
    from the cloud and the current ice state, zenith angles, the column
    and dynamics forcing) is computed per block on the device, per cell,
    so each block's forcing equals the unpartitioned runner's on its
    cells.  The state check runs on every block; a failure writes the
    abort dump in the per-block layout (no per-cell dump).  Output and
    restart use the per-block I/O (`io/parallel.py`): the step never
    gathers the state.  analysis: an `analysis.AnalysisDriver`, or None;
    its members see the whole mesh (`parallel.sharded.GlobalView`), the
    state gathered on the device after a step in which one of them
    precomputes or computes.

    Across ranks (the model's process group) every rank runs the loop
    over its own blocks: it reads the forcing records and scatters them
    to its blocks, writes the part files of its blocks (rank 0 the
    manifests and the restart timestamp), and gathers with the others
    for the members, which compute on every rank and write on rank 0;
    the state-check flags are reduced across ranks before the abort
    gate, so that every rank takes the same branch.  The runner binds its
    output stream to the model's blocks (`ShardedOutputStream.bind`).
    """

    def __init__(self, model, state,
                 atmos_forcing: Optional[CoreAtmosForcing] = None,
                 ocean_forcing: Optional[NcarOceanForcing] = None,
                 clock: Optional[ModelClock] = None,
                 streams: Optional[RunStreams] = None,
                 analysis=None):
        super().__init__(model, state, atmos_forcing, ocean_forcing, clock,
                         streams, analysis)
        if self.streams.output is not None:
            self.streams.output.bind(model)
        if analysis is not None:
            from .parallel.sharded import GlobalView
            self._view = GlobalView(model)
            whole = model.gather_state(state)
            analysis.bootstrap(self._view, whole)
            analysis.init(self._view, whole)
        gm = model.global_mesh
        nc = gm.n_cells

        def field(name):
            a = getattr(gm, name, None)
            return np.zeros(nc) if a is None else np.asarray(a)

        (self._lat, self._lon), _ = self._scatter(
            [field("lat_cell"), field("lon_cell")])

    def _scatter(self, fields, scalars=()):
        """Global cell fields (numpy) -> for each field, a list of the
        rank's blocks' tensors in the model dtype, and the scalars as 0-d
        tensors, all in one copy."""
        model = self.model
        n = len(model.blocks)
        blocks = [model.local_blocks(model.part.scatter_cell_field(
            np.asarray(f, np.float64))) for f in fields]
        views = upload([b[s] for b in blocks for s in range(n)] +
                       [np.float64(x) for x in scalars],
                       self.dtype, self.device)
        k = len(fields) * n
        return [views[i * n:(i + 1) * n] for i in range(len(fields))], \
            views[k:]

    def _to_device(self, groups, scalars):
        """Per group, a list over blocks of that block's records."""
        names = [(gi, k) for gi, g in enumerate(groups) for k in g]
        per_field, clock_t = self._scatter(
            [groups[gi][k] for gi, k in names], scalars)
        dicts = [[{} for _ in self.model.blocks] for _ in groups]
        for (gi, k), blocks in zip(names, per_field):
            for s, t in enumerate(blocks):
                dicts[gi][s][k] = t
        return dicts, clock_t

    def _device_step(self, tensors, halo, states, sixh, monthly, ocn_raw,
                     seconds_today, day_of_year):
        """Per block: `step_inputs` of the unpartitioned runner; then the
        partitioned step of all blocks."""
        dt_step = self.model.cfg.run.dt
        use_col = self.model.cfg.column.use_column_package
        ins = [step_inputs(
            st, sixh and sixh[s], monthly and monthly[s],
            ocn_raw and ocn_raw[s], self._lon[s], self._lat[s],
            seconds_today, day_of_year, dt_step, use_col)
            for s, st in enumerate(states)]
        dyn, atmf, ocnf, coszen = (list(x) for x in zip(*ins))
        if atmf[0] is None:
            atmf = ocnf = coszen = None
        return self.step_fn(tensors, halo, states, dyn, atmf, ocnf, coszen,
                            day_of_year, self._lat)

    def _advance(self, raw):
        model = self.model
        self.state, self.diags = self._device_step(
            model.tensors, model.halo, self.state, *raw)
        # every block's checks (its halo copies included), merged
        per = [state_checks(st, d)[0] for st, d in
               zip(self.state, self.diags)]
        return {k: torch.stack([c[k] for c in per]).all()
                for k in per[0]}, None

    def _abort_gate(self, checks, cell_masks):
        raise_on_failed_checks(checks, self.state, self.clock.timestamp(),
                               run_dir=self.streams.restart_dir,
                               write_dump=self._write_abort_dump,
                               comm=self.model.comm)

    def _analyse(self):
        """The members on the whole mesh: the state and the diagnostics
        they read gathered on the device, cells from their owners, in a
        step where a member precomputes or computes."""
        model = self.model

        def diags(keys):
            return {k: model.gather_cells([d[k] for d in self.diags])
                    for k in keys if k in self.diags[0]}

        self.analysis.on_timestep(self._view,
                                  lambda: model.gather_state(self.state),
                                  self.clock, diags,
                                  write=model.comm.rank == 0)

    def _write_abort_dump(self, run_dir, states, timestamp, failed):
        from .io.parallel import save_sharded_checkpoint
        model = self.model
        os.makedirs(run_dir, exist_ok=True)
        name = f"abort.{timestamp}"
        save_sharded_checkpoint(
            run_dir, name, states, model.part, model.global_mesh.n_cells,
            model.global_mesh.n_vertices, clock_metadata={
                "year": self.clock.year, "seconds": self.clock.seconds,
                "failed_checks": [str(f) for f in failed]},
            shards=model.block_ids, comm=model.comm)
        return os.path.join(run_dir, name)

    def _write_output(self):
        st = self.state
        self.streams.output.write(
            {"iceAreaCell": [s.tracers["iceAreaCategory"].sum(-1)
                             for s in st],
             "iceVolumeCell": [s.tracers["iceVolumeCategory"].sum(-1)
                               for s in st]},
            {"uVelocity": [s.velocity.u_velocity for s in st],
             "vVelocity": [s.velocity.v_velocity for s in st]},
            self.clock.timestamp())

    def _write_restart(self):
        from .io.parallel import save_sharded_checkpoint
        model, ts = self.model, self.clock.timestamp()
        save_sharded_checkpoint(
            self.streams.restart_dir, f"restart.{ts}", self.state,
            model.part, model.global_mesh.n_cells,
            model.global_mesh.n_vertices,
            clock_metadata={"year": self.clock.year,
                            "seconds": self.clock.seconds},
            shards=model.block_ids, comm=model.comm)
        if model.comm.rank == 0:
            write_restart_timestamp(self.streams.restart_dir, ts)
        model.comm.barrier()
