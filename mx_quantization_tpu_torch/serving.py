"""Continuous-batching diffusion serving (port of the JAX package's
``serving.py``).

Design, as in JAX:

  * The server keeps a fixed pool of ``slots``.  Every engine step runs ONE
    denoising step for every slot at its own timestep: each slot carries
    its own timestep index, latent and condition (the models take
    per-sample timesteps), so a new request starts at the next step
    instead of waiting for the current batch to finish.  The whole pool
    runs every step; inactive slots are computed and masked, so the
    kernels see one shape.
  * All slot state lives on the device: latents, timestep indices, the
    active mask, the conditions (and DPM-Solver++'s ``prev_x0``).  The
    engine step updates the pool; refills write one slot (noise drawn on
    the device, the request's condition uploaded through pinned memory).
  * Finish handling is dispatch-first: right after step N is enqueued, its
    finished mask and finished latents are copied into pinned host
    buffers without waiting, behind an event.  Step N+1 is enqueued
    before the host waits on step N's event, so the host's wait and read
    overlap the device running step N+1.  A finished slot idles two
    engine steps before its refill.  Nothing on the dispatch or the
    refill waits for the device.
  * CFG is folded in by doubling the model batch inside the step.

Random numbers come from one generator on the device, in a fixed order: at
a refill one (C, H, W) draw per filled slot, in slot order; at each
dispatched DDPM step one (slots, C, H, W) draw.  Replaying a generator from
the same seed in that order gives the server's initial latents and step
noise.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .diffusion import GaussianDiffusion, create_diffusion
from .diffusion.dpm_solver import DPMSolverMultistep


@dataclasses.dataclass
class Request:
    request_id: int
    condition: object            # class label (DiT) or a dict of arrays
    # (PixArt: {"embeds": (L, 4096), "mask": (L,)} — any structure matching
    # the server's null_condition)
    # stamped by submit(): Result.latency_s measures from here, so queue
    # wait is part of the reported latency
    submit_t: float = 0.0


@dataclasses.dataclass
class Result:
    request_id: int
    latent: np.ndarray
    steps: int
    latency_s: float             # completion minus submit(): includes the
    # queue wait
    queue_wait_s: float = 0.0    # slot fill minus submit()


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a condition: a dict (possibly nested) or
    one leaf; ``rest`` has the same structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _cfg_batch(cond, null_condition):
    """(2S, ...) conditions: the slots' then the null condition's."""
    return _tree_map(lambda c, n: torch.cat([c, n.expand(c.shape)], dim=0),
                     cond, null_condition)


def _finish(lat, new_lat, step_idx, active):
    """The masked update shared by both engines: (new_lat, new_step_idx,
    new_active, finished, fin_lat)."""
    new_lat = torch.where(active[:, None, None, None], new_lat, lat)
    finished = active & (step_idx == 0)
    new_active = active & ~finished
    new_step_idx = torch.where(new_active, step_idx - 1, step_idx)
    fin_lat = torch.where(finished[:, None, None, None], new_lat,
                          torch.zeros_like(new_lat))
    return new_lat, new_step_idx, new_active, finished, fin_lat


def engine_step(model_fn, diffusion: GaussianDiffusion, null_condition,
                cfg_scale, slots, params, lat, step_idx, active, cond,
                noise):
    """One DDPM denoise step for every slot at its own timestep.

    ``null_condition`` is on the device, unbatched; ``noise`` is the
    step's (slots, C, H, W) standard-normal draw.  Returns (new_lat,
    new_step_idx, new_active, finished, fin_lat): a slot at step_idx == 0
    runs its final (no-noise) step and flips to finished; ``finished`` and
    ``fin_lat`` (the finished slots' latents, zeros elsewhere) are fresh
    tensors that the next step does not write."""
    S = slots
    t = diffusion.model_t(step_idx).to(torch.float32)

    # CFG doubling: cond batch then null batch
    lat2 = torch.cat([lat, lat], dim=0)
    t2 = torch.cat([t, t], dim=0)
    cond2 = _cfg_batch(cond, null_condition)
    out = (model_fn(params, lat2, t2, cond2)
           if params is not None else model_fn(lat2, t2, cond2))
    # CFG on the first 3 channels only (reference models.py:452-476)
    eps_all, rest = out[:, :3], out[:, 3:]
    c_eps, u_eps = eps_all.chunk(2, dim=0)
    eps = u_eps + cfg_scale * (c_eps - u_eps)
    model_out = torch.cat([eps, rest[:S]], dim=1)

    mean, log_var, _ = diffusion.p_mean_variance(model_out, lat, step_idx)
    nonzero = (step_idx > 0).to(lat.dtype)[:, None, None, None]
    new_lat = mean + nonzero * torch.exp(0.5 * log_var) * noise
    return _finish(lat, new_lat, step_idx, active)


def dpm_tables(num_inference_steps: int,
               solver: Optional[DPMSolverMultistep] = None,
               device="cpu") -> Dict[str, torch.Tensor]:
    """Per-slot-step DPM-Solver++(2M) coefficient tables on ``device``,
    indexed by the server's countdown ``step_idx`` (num_inference_steps-1
    = first solver step ... 0 = final step), computed in float64 numpy
    and rounded to float32 once.

    Returns dict of (num_inference_steps,) float32 tensors:
      t      model timestep fed to the network
      inv_a  1/alpha_t        sg     sigma_t        (x0 = (x - sg*eps)*inv_a)
      ratio  sigma_s/sigma_t  coef   alpha_s*expm1(-h)
      inv2r  1/(2r) with r = h_prev/h (0.0 at the first step -> the 2M
             correction term vanishes and the update degenerates to 1st
             order exactly as the sequential sampler's prev_x0 is None)
    """
    sv = solver or DPMSolverMultistep()
    ts = sv.timesteps(num_inference_steps)          # descending model t
    NI = num_inference_steps
    out = {k: np.zeros((NI,), np.float32)
           for k in ("t", "inv_a", "sg", "ratio", "coef", "inv2r")}
    for j in range(NI):                              # j = step_idx countdown
        si = NI - 1 - j                              # position in ts
        t_idx = int(ts[si])
        s_t = int(ts[si + 1]) if si + 1 < NI else 0
        h = sv.lambda_t[s_t] - sv.lambda_t[t_idx]
        out["t"][j] = float(t_idx)
        out["inv_a"][j] = 1.0 / sv.alpha_t[t_idx]
        out["sg"][j] = sv.sigma_t[t_idx]
        out["ratio"][j] = sv.sigma_t[s_t] / sv.sigma_t[t_idx]
        out["coef"][j] = sv.alpha_t[s_t] * float(np.expm1(-h))
        if si > 0 and h != 0:
            h_prev = sv.lambda_t[t_idx] - sv.lambda_t[int(ts[si - 1])]
            out["inv2r"][j] = float(h / (2.0 * h_prev))
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def engine_step_dpm(model_fn, tables, null_condition, cfg_scale, slots,
                    eps_channels, params, lat, step_idx, prev_x0, active,
                    cond):
    """One DPM-Solver++(2M) step for every slot at its own solver position
    (the PixArt-alpha serving engine; ``tables`` from ``dpm_tables`` on the
    pool's device).  Deterministic: no per-step noise.  Per-slot multistep
    state is ``prev_x0``, the previous step's data prediction.

    CFG follows the PixArt pipeline: guidance on the FULL epsilon
    (out[:, :eps_channels]; learned-variance channels dropped).  Returns
    (new_lat, new_step_idx, new_prev_x0, new_active, finished, fin_lat).
    """
    t = tables["t"][step_idx]

    lat2 = torch.cat([lat, lat], dim=0)
    t2 = torch.cat([t, t], dim=0)
    cond2 = _cfg_batch(cond, null_condition)
    out = (model_fn(params, lat2, t2, cond2)
           if params is not None else model_fn(lat2, t2, cond2))
    eps2 = out[:, :eps_channels]
    c_eps, u_eps = eps2.chunk(2, dim=0)
    eps = u_eps + cfg_scale * (c_eps - u_eps)

    def bcast(name):
        return tables[name][step_idx][:, None, None, None]

    x0 = (lat - bcast("sg") * eps) * bcast("inv_a")
    # 2M correction: d = (1 + 1/(2r)) x0 - 1/(2r) prev_x0; dpm_tables
    # stores inv2r == 0 at a slot's first step (no prev_x0 yet) -> d == x0
    # (exact 1st order), so a stale prev_x0 needs no reset
    inv2r = bcast("inv2r")
    d = (1.0 + inv2r) * x0 - inv2r * prev_x0
    new_lat = bcast("ratio") * lat - bcast("coef") * d
    new_prev_x0 = torch.where(active[:, None, None, None], x0, prev_x0)
    new_lat, new_step_idx, new_active, finished, fin_lat = _finish(
        lat, new_lat, step_idx, active)
    return (new_lat, new_step_idx, new_prev_x0, new_active, finished,
            fin_lat)


class DiffusionServer:
    """Continuous-batching sampler around a CFG denoise model.

    model_fn(latents (2S, C, H, W), t (2S,), cond) -> (2S, 2C, H, W), or
    model_fn(params, latents, t, cond) when ``params`` is given.

    ``cond`` is a tensor or a dict of tensors batched on axis 0 (slots): an
    int64 label tensor for DiT, or e.g. {"embeds": (S, L, 4096), "mask":
    (S, L)} for PixArt text conditioning.  ``null_condition`` supplies the
    null (CFG) value with the same structure, unbatched; requests carry
    conditions of that structure (numpy arrays, Python numbers or
    tensors).
    """

    def __init__(self, model_fn: Callable, latent_shape, num_steps: int,
                 slots: int = 8, null_condition=1000,
                 cfg_scale: float = 4.0, seed: int = 0, mesh=None,
                 params=None, solver: str = "ddpm",
                 eps_channels: Optional[int] = None, device="cuda"):
        """``solver``: "ddpm" (the DiT ancestral sampler, ``engine_step``)
        or "dpm++" (DPM-Solver++ 2M, ``engine_step_dpm``: the PixArt-alpha
        operating point's scheduler, deterministic per request).
        ``eps_channels``: CFG channel count for dpm++ (defaults to the
        latent channel count: guide the full epsilon, drop the
        learned-variance channels).  ``device``: where the pool lives and
        the model runs (the card unless "cpu"); ``seed`` seeds the
        server's generator on it."""
        if mesh is not None:
            raise NotImplementedError(
                "a server over a device mesh is not ported yet (ROADMAP.md "
                "section 1, parallelism)")
        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.params = params
        self.latent_shape = tuple(latent_shape)  # (C, H, W)
        self.slots = slots
        self.cfg_scale = cfg_scale
        self.solver = solver
        if solver == "dpm++":
            self.num_steps = num_steps
            self._tables = dpm_tables(num_steps, device=self.device)
            self.eps_channels = eps_channels or self.latent_shape[0]
            self.diffusion = None
        elif solver == "ddpm":
            self.diffusion = create_diffusion(str(num_steps))
            self.diffusion.device_tables(self.device)  # upload them now
            self.num_steps = self.diffusion.num_timesteps
        else:
            raise ValueError(f"unknown solver {solver!r}")

        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._results: Dict[int, Result] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.dispatches = 0

        # ---- device-resident slot state
        C, H, W = self.latent_shape
        dev = self.device
        self._null = _tree_map(self._device_leaf, null_condition)
        self._lat = torch.zeros((slots, C, H, W), device=dev)
        self._step_idx = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self._active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._prev_x0 = (torch.zeros_like(self._lat)
                         if solver == "dpm++" else None)
        self._cond = _tree_map(
            lambda n: n.expand((slots,) + n.shape).clone(), self._null)

        # host mirrors for scheduling only (the device tensors are
        # authoritative for compute); _host_busy includes finished-but-not-
        # drained slots.  _host_steps_left mirrors the device step_idx
        # (num_steps at refill, -1 per dispatch): a slot with 0 left is
        # finished-awaiting-drain, and step() skips the dispatch when every
        # busy slot is in that state
        self._host_busy = np.zeros((slots,), bool)
        self._host_steps_left = np.zeros((slots,), np.int64)
        self._req: List[Optional[Request]] = [None] * slots
        self._t0 = np.zeros((slots,), np.float64)
        # the step in flight: (finished mask, finished latents, event)
        self._pending: Optional[Tuple[torch.Tensor, torch.Tensor,
                                      Optional[torch.cuda.Event]]] = None
        # two pinned (mask, latents) buffers that alternate: step N+1's
        # copies are enqueued before the host reads step N's
        self._staging = None
        if dev.type == "cuda":
            self._staging = [
                (torch.empty((slots,), dtype=torch.bool, pin_memory=True),
                 torch.empty((slots, C, H, W), pin_memory=True))
                for _ in range(2)]

    # ------------------------------------------------------------------
    def _device_leaf(self, value) -> torch.Tensor:
        """A null-condition leaf on the device (float64 arrays become
        float32, as JAX's arrays do)."""
        x = torch.as_tensor(value)
        if x.dtype == torch.float64:
            x = x.to(torch.float32)
        return x.to(self.device)

    def _upload(self, buf: torch.Tensor, value) -> None:
        """Write one condition leaf into ``buf`` (a slot's view) without
        waiting: host values go through pinned memory."""
        src = torch.as_tensor(value).to(buf.dtype)
        if src.device.type == "cpu" and self.device.type == "cuda":
            src = src.pin_memory()
        buf.copy_(src.reshape(buf.shape), non_blocking=True)

    def _refill(self, s: int, condition) -> None:
        """Activate slot ``s``: fresh noise drawn on the device, the index
        reset, the condition uploaded into that slot only (dpm++'s
        prev_x0 needs no write: inv2r is zero at a slot's first step)."""
        self._lat[s].copy_(torch.randn(self.latent_shape,
                                       generator=self._gen,
                                       device=self.device))
        self._step_idx[s].fill_(self.num_steps - 1)
        self._active[s].fill_(True)
        _tree_map(lambda buf, v: self._upload(buf[s], v), self._cond,
                  condition)

    def _dispatch(self):
        """Enqueue one engine step over the pool and the copies of its
        finish buffers to the host; returns the pending entry."""
        if self.solver == "dpm++":
            (self._lat, self._step_idx, self._prev_x0, self._active,
             fin, fin_lat) = engine_step_dpm(
                self.model_fn, self._tables, self._null, self.cfg_scale,
                self.slots, self.eps_channels, self.params, self._lat,
                self._step_idx, self._prev_x0, self._active, self._cond)
        else:
            noise = torch.randn((self.slots,) + self.latent_shape,
                                generator=self._gen, device=self.device)
            (self._lat, self._step_idx, self._active, fin,
             fin_lat) = engine_step(
                self.model_fn, self.diffusion, self._null, self.cfg_scale,
                self.slots, self.params, self._lat, self._step_idx,
                self._active, self._cond, noise)
        self.dispatches += 1
        if self._staging is None:
            return fin, fin_lat, None
        fin_h, lat_h = self._staging[self.dispatches % 2]
        fin_h.copy_(fin, non_blocking=True)
        lat_h.copy_(fin_lat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return fin_h, lat_h, done

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        req.submit_t = time.perf_counter()
        self._queue.put(req)
        return req.request_id

    @torch.no_grad()
    def _fill_slots(self):
        """Refill free slots from the queue."""
        for s in range(self.slots):
            if self._host_busy[s]:
                continue
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            self._refill(s, req.condition)
            self._host_busy[s] = True
            self._host_steps_left[s] = self.num_steps
            self._req[s] = req
            self._t0[s] = time.perf_counter()

    def _drain_pending(self) -> List[Result]:
        """Read the previous step's finished slots: waits on that step's
        event only, while the step just dispatched runs on the device."""
        if self._pending is None:
            return []
        fin_h, lat_h, done = self._pending
        self._pending = None
        if done is not None:
            done.synchronize()
        fin = fin_h.numpy()
        finished: List[Result] = []
        for s in np.nonzero(fin)[0]:
            req = self._req[s]
            res = Result(req.request_id, lat_h[s].numpy().copy(),
                         self.num_steps, time.perf_counter() - req.submit_t,
                         queue_wait_s=self._t0[s] - req.submit_t)
            self._results[req.request_id] = res
            finished.append(res)
            self._host_busy[s] = False
            self._req[s] = None
        return finished

    @torch.no_grad()
    def step(self) -> List[Result]:
        """Dispatch one engine step, then drain the PREVIOUS step's finish
        buffers, then refill freed slots for the NEXT dispatch."""
        new_pending = None
        # dispatch only when some busy slot still needs compute: at a full
        # drain boundary every busy slot can be finished-awaiting-drain,
        # and a dispatch would run a whole model step on no active slot
        needs = self._host_busy & (self._host_steps_left > 0)
        if needs.any():
            new_pending = self._dispatch()
            self._host_steps_left -= needs
        results = self._drain_pending()
        self._pending = new_pending
        self._fill_slots()
        return results

    def run_until_drained(self, max_steps: int = 100000) -> Dict[int, Result]:
        """Serve until the queue, all slots, and the pending buffer are
        empty."""
        for _ in range(max_steps):
            self.step()
            if (self._queue.empty() and not self._host_busy.any()
                    and self._pending is None):
                break
        # final drain (the last step's finishes are still pending)
        self._drain_pending()
        return self._results
