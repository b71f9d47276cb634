"""Serving front end: the fault-tolerant CV batch engine `CvEngine`, and the
LM serving steps (prefill, greedy decode against a KV cache, `generate`).
The counterpart of `repro.serve.cv_engine`.

`CvEngine` hardens the BoW / CV pipeline end to end, as JAX's does:

  * **Batching and padding to a bucket**: requests are grouped by the
    smallest bucket shape that fits (edge-padded), then by shape and dtype,
    and split by `max_batch`, so a few canonical shapes cover the traffic.
  * **Degradation ladder**: every batch runs under the engine's ladder; a
    rung that raises is retried with exponential backoff, then the engine
    moves to the next rung and records a `core.faultinject` event.  The
    rung goes down the pipeline as an explicit ``mode=`` (to
    `pipeline.extract_features` and to the classifier tail: ``"ref"`` for
    the ``"ref"`` rung, ``"fused"`` otherwise), never through the process
    default.  A `ValueError` (a misconfiguration) propagates.
  * **Admission control**: NaN / Inf float frames are sanitized (or
    rejected, ``bad_input="reject"``) with an event; a frame of bad rank or
    dtype gets an error `Response` instead of failing its batch.
  * **Deadlines and bounded retry**: a request's deadline is checked
    before dispatch and after; a retry whose backoff sleep would pass the
    batch's nearest deadline is abandoned and the ladder moves on.
  * **Warm plan table**: ``warm()`` runs `autotune.measure_chain` for a
    bucket under a deadline and a `train.fault.StragglerWatchdog`; a
    measurement timeout records an event and returns None.
  * **Sharded fan-out**: with a dispatcher of more than one fault domain
    (``mesh=`` of several devices, or ``dispatcher=``), batches go through
    `serve.shard_dispatch.ShardDispatcher`.

Departures from JAX.  Two follow the port's rule that the plain version is
never a rung on the card:

  * on a CUDA engine the default ladder is the kernel rungs only,
    ``("streaming", "tiled2d", "window")`` (`KERNEL_LADDER`); on the CPU it
    is JAX's `DEFAULT_LADDER`, ending in ``"ref"``;
  * on a CUDA engine a ladder in which ``"ref"`` follows another rung
    raises `ValueError` at construction, before anything runs;
    ``ladder=("ref",)`` alone is the caller's explicit choice of the plain
    version and is allowed, as ``mode="ref"`` is.  The dispatcher keeps the
    same rule.

The third follows the card's shared memory: a rung whose plan does not fit
the batch's shape (`stencil.PlanOverBudget`, a `ValueError`: e.g. full-width
streaming rings over a block's 227 KB, as the f32 octave chain's are on
planes 240 pixels wide and wider) moves to the next rung at once, with an
event and no retry, where JAX lets every `ValueError` through.  Without it
the default engine could not serve the 256x256 bucket on the card.  Every
other `ValueError` propagates, as in JAX; the dispatcher does the same.

Unlike JAX's, the port's `fused_chain` launches the mode it is given on
planes no larger than the chain's halo (JAX runs its plain version there),
so the streaming rung launches `stencil_stream` on the 32x32 bucket too.
`Response.desc`, ``.valid`` and ``.pred`` are host numpy values.  Faults
are injected from ``REPRO_TORCH_FAULT_SPEC``; ``python -m
repro_torch.serve.cv_engine --smoke [--device cpu]`` runs JAX's smoke
workload under it and exits non-zero on any unexpected failure.

The LM half runs eagerly under `torch.inference_mode()` on one device;
there is no mesh and no sharding hint, and the KV cache is written in
place (`models.attention.gqa_decode`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..core import autotune, faultinject
from ..core.device import resolve_device
from ..cv import classify, features, pipeline
from ..cv.config import _UNSET, PipelineConfig, resolve_config
from ..kernels.stencil import PlanOverBudget
from ..kernels.stencil.ladder import DEGRADATION_LADDER
from ..models import lm
from ..models.blocks import CONTEXT_ENTRIES, STATE_KINDS
from ..sharding import comm, rules
from ..train.fault import StragglerWatchdog
from .shard_dispatch import KERNEL_LADDER, ShardDispatcher, check_ladder

DEFAULT_BUCKETS = ((32, 32), (64, 64), (128, 128), (256, 256))
DEFAULT_LADDER = DEGRADATION_LADDER  # streaming -> tiled2d -> window -> ref (the CPU's default)


@dataclass
class Request:
    """One frame in; deadline is absolute (time.monotonic() seconds)."""
    image: object
    deadline: float | None = None


@dataclass
class Response:
    index: int                       # position in the submitted workload
    ok: bool
    desc: np.ndarray | None = None   # extract task: (max_kp, 128) descriptors
    valid: np.ndarray | None = None
    pred: int | None = None          # classify task
    bucket: tuple | None = None
    plan: str | None = None          # the rung that produced the answer
    retries: int = 0
    degraded: bool = False
    deadline_missed: bool = False
    shard: int | None = None         # data-axis shard that served this request
    device: str | None = None        # device_key of the serving device
    error: str | None = None
    events: list = field(default_factory=list)
    latency_s: float = 0.0


def _host(img) -> np.ndarray:
    return img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


class CvEngine:
    """Batch-serving engine over `cv.pipeline` with a degradation ladder.

    task "extract" serves descriptor sets (no model needed); task
    "classify" serves class predictions through the `cv.classify`
    `ClassifyPlan` tail (pass a trained `BowSvmModel` / `BowGbdtModel`).
    Pipeline knobs come in via ``config=``; the old `max_kp=`,
    `n_octaves=` and `preprocess=` keywords survive as deprecation shims
    (`cv.config.resolve_config`).  `device` (None = "cuda", raising
    without one) is where batches run; ``ladder=None`` takes the device's
    default (module docstring)."""

    def __init__(self, model=None, config: PipelineConfig | None = None, *,
                 buckets=DEFAULT_BUCKETS,
                 max_batch: int = 64, ladder=None,
                 max_retries: int = 1, backoff_s: float = 0.01,
                 bad_input: str = "sanitize", max_kp=_UNSET,
                 n_octaves=_UNSET, preprocess=_UNSET,
                 capture_frames: bool = False, watchdog=None,
                 mesh=None, dispatcher: ShardDispatcher | None = None,
                 device=None):
        if bad_input not in ("sanitize", "reject"):
            raise ValueError(f"bad_input must be 'sanitize' or 'reject', "
                             f"got {bad_input!r}")
        self.device = resolve_device(device)
        card = self.device.type == "cuda"
        if ladder is None:
            ladder = KERNEL_LADDER if card else DEFAULT_LADDER
        ladder = check_ladder(ladder, card, "CvEngine")
        cfg = resolve_config(config, where="CvEngine", max_kp=max_kp,
                             n_octaves=n_octaves, preprocess=preprocess)
        self.model = model
        self.config = cfg
        self.plan = (classify.build_plan(model, cfg, device=self.device)
                     if model is not None else None)
        self.buckets = tuple(sorted(tuple(b) for b in buckets))
        self.max_batch = int(max_batch)
        self.ladder = ladder
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.bad_input = bad_input
        self.max_kp = int(cfg.max_kp)
        self.n_octaves = int(cfg.n_octaves)
        self.preprocess = bool(cfg.preprocess)
        self.capture_frames = bool(capture_frames)
        self.watchdog = watchdog if watchdog is not None else \
            StragglerWatchdog(threshold=4.0, warmup=2)
        if dispatcher is not None and mesh is not None:
            raise ValueError("pass mesh= OR dispatcher=, not both")
        if dispatcher is None and mesh is not None:
            dispatcher = ShardDispatcher(mesh, ladder=ladder, device=self.device)
        self.dispatcher = dispatcher
        self.captured: list = []     # (bucket, canonical batch) when capturing
        self.stats = {"served": 0, "errors": 0, "degraded_batches": 0,
                      "retries": 0, "deadline_missed": 0, "sanitized": 0,
                      "sharded_batches": 0, "shard_failures": 0}

    @property
    def signature(self) -> str:
        """Workload identity half of the circuit-breaker key: one string
        per (task, pipeline knobs); bucket and rung complete the key."""
        task = "classify" if self.model is not None else "extract"
        return (f"cv:{task}:kp{self.max_kp}:oct{self.n_octaves}"
                f":pre{int(self.preprocess)}")

    # -- admission -----------------------------------------------------------

    def _admit(self, req: Request, idx: int):
        """One frame -> (canonical np array, events) or an error Response.
        `faultinject.poison` sees float frames only, as JAX's does, so an
        integer frame consumes no ``nan_input`` firing."""
        events = []
        arr = _host(req.image)
        if arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[-1] not in (1, 3)):
            return None, Response(
                index=idx, ok=False,
                error=f"bad_rank: expected (H, W) or (H, W, {{1,3}}), "
                      f"got {arr.shape}")
        if not (np.issubdtype(arr.dtype, np.floating)
                or arr.dtype == np.uint8):
            return None, Response(
                index=idx, ok=False,
                error=f"bad_dtype: expected uint8/float, got {arr.dtype}")
        fired = False
        if np.issubdtype(arr.dtype, np.floating):
            t, fired = faultinject.poison(torch.from_numpy(arr), site=f"admit:{idx}")
            arr = t.numpy() if fired else arr
            bad = ~np.isfinite(arr)
            if bad.any():
                if self.bad_input == "reject":
                    return None, Response(
                        index=idx, ok=False,
                        error=f"bad_values: {int(bad.sum())} NaN/Inf pixels"
                              + (" (injected)" if fired else ""))
                arr = np.nan_to_num(arr, nan=0.0, posinf=255.0, neginf=0.0)
                events.append(faultinject.record_degradation(
                    stage="serve", from_plan="raw-input", to_plan="sanitized",
                    reason=f"{int(bad.sum())} NaN/Inf pixels zeroed/clamped",
                    detail=f"request {idx}", injected=fired))
                self.stats["sanitized"] += 1
        return arr, events

    # -- bucketing -----------------------------------------------------------

    def _bucket_of(self, shape) -> tuple | None:
        """Smallest bucket that fits (H, W); None = serve at exact shape."""
        h, w = shape[:2]
        if faultinject.should_fire("bucket_miss", site=f"bucket:{h}x{w}"):
            faultinject.record_degradation(
                stage="serve", from_plan="bucketed", to_plan="exact-shape",
                reason="bucket miss (injected): padding skipped",
                detail=f"{h}x{w}", injected=True)
            return None
        for bh, bw in self.buckets:
            if h <= bh and w <= bw:
                return (bh, bw)
        faultinject.record_degradation(
            stage="serve", from_plan="bucketed", to_plan="exact-shape",
            reason="frame larger than every bucket", detail=f"{h}x{w}")
        return None

    @staticmethod
    def _pad_to(arr: np.ndarray, bucket: tuple | None) -> np.ndarray:
        if bucket is None:
            return arr
        ph, pw = bucket[0] - arr.shape[0], bucket[1] - arr.shape[1]
        if ph == 0 and pw == 0:
            return arr
        pad = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pad, mode="edge")

    # -- ladder execution ----------------------------------------------------

    def _batch_fn(self, x: torch.Tensor, rung: str) -> dict:
        """Per-rung batch computation: (B, H, W[, C]) tensor on a device ->
        dict of batch-leading tensors there.  No host sync, no timing; both
        the local ladder (`_run_batch`) and the sharded dispatcher run
        through it.  The stencil rung maps onto the classifier tail's two
        modes: "ref" classifies through the plain versions, every kernel
        rung through the fused tail."""
        feats = pipeline.extract_features(
            x, self.config.replace(mode=rung), device=x.device, validate=False)
        if self.plan is not None:
            cmode = "ref" if rung == "ref" else "fused"
            hists = self.plan.histograms(feats["desc"], feats["valid"],
                                         mode=cmode)
            return {"pred": self.plan.classify(hists, mode=cmode)}
        return {"desc": feats["desc"], "valid": feats["valid"]}

    def _run_batch(self, batch: np.ndarray, rung: str) -> dict:
        """One canonical batch through the pipeline at one explicit rung,
        the outputs back on the host."""
        out = self._batch_fn(torch.from_numpy(batch).to(self.device), rung)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _run_ladder(self, batch: np.ndarray, deadlines=()):
        """Ladder + bounded retry; returns (result, plan, retries, events)
        or raises only if the FINAL rung fails every attempt.

        `deadlines` carries the batch's absolute request deadlines: a
        retry whose backoff sleep would overrun the tightest one is
        abandoned (deadline_missed, NOT a retry) and the ladder degrades
        immediately — sleeping through a deadline to honor the retry
        budget would answer every request in the batch late."""
        events, retries = [], 0
        nearest = min((d for d in deadlines if d is not None), default=None)
        for i, rung in enumerate(self.ladder):
            last_rung = i == len(self.ladder) - 1
            for attempt in range(self.max_retries + 1):
                try:
                    return self._run_batch(batch, rung), rung, retries, events
                except PlanOverBudget as e:
                    # the rung cannot plan this batch's shape: the next one
                    # at once, on the record (planning is deterministic, so
                    # no retry)
                    if last_rung:
                        raise
                    events.append(faultinject.record_degradation(
                        stage="serve", from_plan=rung, to_plan=self.ladder[i + 1],
                        reason=f"rung cannot plan this batch: {e}"))
                    break
                except ValueError:
                    raise            # misconfiguration: no rung may mask it
                except Exception as e:
                    injected = isinstance(e, faultinject.InjectedFault)
                    if attempt < self.max_retries:
                        sleep_s = self.backoff_s * (2 ** attempt)
                        if (nearest is not None
                                and time.monotonic() + sleep_s > nearest):
                            self.stats["deadline_missed"] += 1
                            events.append(faultinject.record_degradation(
                                stage="serve", from_plan=rung,
                                to_plan=rung if last_rung
                                else self.ladder[i + 1],
                                reason=f"retry abandoned: {sleep_s:.3f}s "
                                       f"backoff would sleep past the batch "
                                       f"deadline ({type(e).__name__}: {e})",
                                injected=injected))
                            if last_rung:
                                raise
                            break    # degrade now instead of sleeping late
                        retries += 1
                        self.stats["retries"] += 1
                        events.append(faultinject.record_degradation(
                            stage="serve", from_plan=rung, to_plan=rung,
                            reason=f"retry {attempt + 1}/{self.max_retries}: "
                                   f"{type(e).__name__}: {e}",
                            injected=injected))
                        time.sleep(sleep_s)
                        continue
                    if last_rung:
                        raise
                    events.append(faultinject.record_degradation(
                        stage="serve", from_plan=rung,
                        to_plan=self.ladder[i + 1],
                        reason=f"rung failed after {attempt + 1} attempt(s): "
                               f"{type(e).__name__}: {e}",
                        injected=injected))
        raise RuntimeError("unreachable: ladder loop exhausted")

    # -- public API ----------------------------------------------------------

    def warm(self, bucket: tuple, *, channels: int = 3, n: int = 1,
             deadline_s: float | None = 5.0, seed: int = 0) -> dict | None:
        """Warm the plan table for one bucket's octave chain; a measurement
        timeout degrades to heuristic routing instead of raising."""
        h, w = bucket
        gen = np.random.default_rng(seed)
        img = torch.from_numpy(gen.random((h, w), dtype=np.float32))
        chain = features.octave_chain(with_next_base=False)
        # route the warm measurement through the health ledger: it runs on
        # the best healthy device and its outcome counts like a shard's
        dev = None
        if self.dispatcher is not None:
            dev = self.dispatcher.health.pick()
        img = img.to(dev if isinstance(dev, torch.device) else self.device)
        t0 = time.monotonic()
        try:
            table = autotune.measure_chain(img, chain, n=n, lc=self.config.lc,
                                           deadline_s=deadline_s,
                                           watchdog=self.watchdog)
            if dev is not None:
                self.dispatcher.health.record_success(
                    dev, time.monotonic() - t0)
            return table
        except autotune.MeasureTimeout as e:
            faultinject.record_degradation(
                stage="serve", from_plan="measured-plan",
                to_plan="heuristic",
                reason=f"warm({h}x{w}) timed out: {e}",
                injected=isinstance(e.__cause__, faultinject.InjectedFault)
                or "injected" in str(e))
            if dev is not None:
                self.dispatcher.health.record_failure(
                    dev, reason=f"warm({h}x{w}) timeout: {e}")
            return None

    def submit(self, workload) -> list[Response]:
        """Serve a workload (arrays or `Request`s) -> one Response each."""
        t_all = time.monotonic()
        reqs = [r if isinstance(r, Request) else Request(r) for r in workload]
        responses: list[Response | None] = [None] * len(reqs)

        # admission + bucketing
        groups: dict = {}
        for idx, req in enumerate(reqs):
            if req.deadline is not None and time.monotonic() > req.deadline:
                self.stats["deadline_missed"] += 1
                responses[idx] = Response(index=idx, ok=False,
                                          deadline_missed=True,
                                          error="deadline_exceeded")
                continue
            arr, admitted = self._admit(req, idx)
            if arr is None:
                responses[idx] = admitted           # error Response
                continue
            bucket = self._bucket_of(arr.shape)
            canon = self._pad_to(arr, bucket)
            gkey = (bucket or canon.shape[:2], canon.shape, str(canon.dtype))
            groups.setdefault(gkey, []).append((idx, canon, admitted))

        # batched execution: sharded fan-out when a dispatcher of more than
        # one fault domain is attached, local ladder otherwise
        sharded = self.dispatcher is not None and self.dispatcher.n_shards > 1
        for (bucket, _, _), members in groups.items():
            for lo in range(0, len(members), self.max_batch):
                part = members[lo:lo + self.max_batch]
                idxs = [m[0] for m in part]
                batch = np.stack([m[1] for m in part])
                if self.capture_frames:
                    self.captured.append((tuple(bucket), batch))
                t0 = time.monotonic()
                if sharded:
                    self._submit_sharded(part, idxs, batch, bucket, reqs,
                                         responses, t0)
                    continue
                try:
                    result, plan, retries, events = self._run_ladder(
                        batch, [reqs[idx].deadline for idx in idxs])
                except ValueError:
                    raise            # caller bug, not a serving fault
                except Exception as e:
                    for idx in idxs:
                        responses[idx] = Response(
                            index=idx, ok=False, bucket=tuple(bucket),
                            error=f"floor_rung_failed: {type(e).__name__}: {e}",
                            events=[ev for _, _, evs in part for ev in evs])
                        self.stats["errors"] += 1
                    continue
                dt = time.monotonic() - t0
                degraded = plan != self.ladder[0] or bool(events)
                if degraded:
                    self.stats["degraded_batches"] += 1
                for k, idx in enumerate(idxs):
                    admit_events = part[k][2]
                    missed = self._deadline_missed(reqs[idx], idx)
                    responses[idx] = Response(
                        index=idx, ok=True,
                        desc=result["desc"][k] if "desc" in result else None,
                        valid=result["valid"][k] if "valid" in result else None,
                        pred=(int(result["pred"][k])
                              if "pred" in result else None),
                        bucket=tuple(bucket), plan=plan, retries=retries,
                        degraded=degraded, deadline_missed=missed,
                        events=list(admit_events) + list(events),
                        latency_s=dt)
                    self.stats["served"] += 1
        self.stats["last_submit_s"] = time.monotonic() - t_all
        return responses  # responses[i] is never None past this point

    def _deadline_missed(self, req: Request, idx: int) -> bool:
        missed = (req.deadline is not None
                  and time.monotonic() > req.deadline)
        if missed:
            self.stats["deadline_missed"] += 1
            faultinject.record_degradation(
                stage="serve", from_plan="on-time", to_plan="late",
                reason="deadline missed post-compute",
                detail=f"request {idx}")
        return missed

    def _submit_sharded(self, part, idxs, batch, bucket, reqs,
                        responses, t0) -> None:
        """One group batch through the sharded dispatcher: per-shard fault
        domains, per-request Responses carrying shard/device identity."""
        try:
            report = self.dispatcher.dispatch(
                batch, self._batch_fn, signature=self.signature,
                bucket=tuple(bucket), mode=self.ladder[0])
        except ValueError:
            raise                    # caller bug, not a serving fault
        except Exception as e:       # dispatcher invariant broke: fail batch
            for k, idx in enumerate(idxs):
                responses[idx] = Response(
                    index=idx, ok=False, bucket=tuple(bucket),
                    error=f"dispatch_failed: {type(e).__name__}: {e}",
                    events=list(part[k][2]))
                self.stats["errors"] += 1
            return
        dt = time.monotonic() - t0
        self.stats["sharded_batches"] += 1
        degraded_batch = False
        for k, idx in enumerate(idxs):
            admit_events = list(part[k][2])
            sres, row = report.result_of(k)
            events = admit_events + list(report.events) + list(sres.events)
            if not sres.ok:
                self.stats["errors"] += 1
                self.stats["shard_failures"] += 1
                responses[idx] = Response(
                    index=idx, ok=False, bucket=tuple(bucket),
                    shard=sres.shard, device=sres.device,
                    error=f"shard_failed: {sres.error}", events=events)
                continue
            degraded = (sres.plan != self.ladder[0] or sres.redispatches > 0
                        or bool(events))
            degraded_batch = degraded_batch or degraded
            missed = self._deadline_missed(reqs[idx], idx)
            responses[idx] = Response(
                index=idx, ok=True,
                desc=(sres.value["desc"][row]
                      if "desc" in sres.value else None),
                valid=(sres.value["valid"][row]
                       if "valid" in sres.value else None),
                pred=(int(sres.value["pred"][row])
                      if "pred" in sres.value else None),
                bucket=tuple(bucket), plan=sres.plan,
                retries=sres.redispatches, degraded=degraded,
                deadline_missed=missed, shard=sres.shard,
                device=sres.device, events=events, latency_s=dt)
            self.stats["served"] += 1
        if degraded_batch:
            self.stats["degraded_batches"] += 1

    def extract(self, imgs) -> list[Response]:
        return self.submit(imgs)

    def classify(self, imgs) -> list[Response]:
        if self.model is None:
            raise ValueError("classify needs a trained model "
                             "(BowSvmModel or BowGbdtModel)")
        return self.submit(imgs)



# ---------------------------------------------------------------------------
# LM serving steps
# ---------------------------------------------------------------------------


def _serve_hint(cfg, mesh):
    return rules.make_hint(mesh, cfg) if mesh is not None else None


def make_prefill_step(cfg=None, mesh=None, *, mode: str | None = None):
    """-> prefill_step(model, tokens (B, S), extras=None) -> (next token (B,)
    int32, cache).  `mode` reaches the attention kernel (``"ref"``: its
    plain version).  With `mesh` (and `cfg`), the model is
    `lm.shard_model`'s, the tokens and extras the global batch, and the
    next tokens and the cache this rank's rows (`lm.prefill`)."""
    hint = _serve_hint(cfg, mesh)

    def prefill_step(model, tokens, extras=None):
        logits, cache = lm.prefill(model, tokens, extras=extras, mode=mode, hint=hint)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_decode_step(cfg=None, mesh=None):
    """-> serve_step(model, cache, tokens (B, 1)) -> (next token (B,) int32,
    cache); with `mesh` (and `cfg`), on this rank's rows (`lm.decode_step`)."""
    hint = _serve_hint(cfg, mesh)

    def serve_step(model, cache, tokens):
        logits, cache = lm.decode_step(model, tokens, cache, hint=hint)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


def generate(
    model: lm.LM,
    prompt_tokens,
    *,
    steps: int,
    cache_len: int | None = None,
    extras: dict | None = None,
    device=None,
    mode: str | None = None,
    mesh=None,
) -> torch.Tensor:
    """Greedy generation: prefill the (B, S) prompts, then decode; returns
    the (B, steps) int32 tokens.  Runs on `device` (None = "cuda"), where
    the model must lie; `mode` reaches the attention kernel of the prefill.
    `extras` holds a cross-attention arch's context input
    (`configs.extra_inputs`: ``image_embeds`` or ``audio_frames``, moved to
    `device`); its rows size the cache's context entries, as JAX sizes them
    from the prefill's context.  A missing or misshapen context input
    (`lm.context_len`) and a prompt that the decode buffers cannot hold
    (`check_prompt_fits`) raise `ValueError` before anything runs.  With
    `mesh` the model is `lm.shard_model`'s on it: every rank passes the
    same prompts, runs the rows `sharding.rules.batch_specs` gives it, holds
    its part of their decode cache (`lm.init_cache(mesh=)`: the time axis
    over "model" where `rules.cache_specs` splits it), and returns every
    row's tokens."""
    dev = resolve_device(device)
    here = model.device
    if here.type != dev.type or (dev.index is not None and here.index != dev.index):
        raise ValueError(f"generate: the model lies on {here}, not on {dev}")
    cfg = model.cfg
    with torch.inference_mode():
        prompt = torch.as_tensor(prompt_tokens, device=dev)
        extras = {name: torch.as_tensor(t, device=dev) for name, t in (extras or {}).items()}
        B, S = prompt.shape
        ctx_len = lm.context_len(cfg, extras, B)
        cache_len = cache_len or (S + steps)
        rows = rules.batch_axes(B, mesh, cfg) if mesh is not None else ()
        cache = lm.init_cache(cfg, B, cache_len, ctx_len=ctx_len, device=dev, mesh=mesh)
        check_prompt_fits(cache, S, cfg)
        decode = make_decode_step(cfg, mesh)
        tok, pcache = make_prefill_step(cfg, mesh, mode=mode)(model, prompt, extras)
        # re-home the prefill cache into the fixed-size decode buffers
        cache = _adopt_prefill(cache, pcache, cfg, mesh=mesh)
        del pcache
        out = [tok]
        for _ in range(steps - 1):
            tok, cache = decode(model, cache, out[-1][:, None])
            out.append(tok)
        out = torch.stack(out, dim=1)
        if rows:
            out = comm.all_gather(out, 0, comm.axes_group(mesh, rows))
        return out


def check_prompt_fits(cache: dict, S: int, cfg) -> None:
    """Raise `ValueError` unless the decode buffers of `cache` can adopt a
    prompt of `S` tokens: every attention run's buffer (`lm._group_cache_len`:
    ``k`` by name, MLA's ``ckv``) holds S slots or is the window's ring,
    and every shared-block application's ring holds S slots.  The state
    kinds hold any prompt; an ``xattn`` run's slots are the context's, not
    the prompt's (a ``dec`` run's ``xk`` / ``xv`` likewise, beside its
    ``k``).  On a mesh the global slots are judged (the cache's
    ``global``)."""
    glob = cache.get("global")
    for gi, ((kind, _), buf) in enumerate(zip(cfg.blocks, cache["groups"])):
        slots = lm._group_cache_len(kind, buf, glob["groups"][gi] if glob else None)
        if slots is not None and S > slots != cfg.window:
            raise ValueError(
                f"a prompt of {S} tokens does not fit a decode cache of {slots} slots "
                f"(window {cfg.window})"
            )
    for i, buf in enumerate(cache.get("shared", [])):
        slots = glob["shared"][i]["k"] if glob else buf["k"].shape[1]
        if S > slots:
            raise ValueError(
                f"a prompt of {S} tokens does not fit the shared block's ring of {slots} slots"
            )


def _put_positions(dst: torch.Tensor, src: torch.Tensor, axis: int, first: int = 0,
                   total: int | None = None) -> None:
    """Copy a prefill entry's S positions (`src`, at `axis`) into a decode
    buffer `dst` that holds slots ``first`` .. of `total` (all of them by
    default): position p to slot p when S <= total, else the last `total`
    positions to slots ``p % total``."""
    S, n = src.shape[axis], dst.shape[axis]
    total = total or n
    src = src.to(dst.dtype)
    if S <= total:
        count = min(n, S - first)
        if count > 0:
            dst.narrow(axis, 0, count).copy_(src.narrow(axis, first, count))
    else:  # slot g holds the position p in [S - total, S) with p % total == g
        g = torch.arange(first, first + n, device=src.device)
        dst.copy_(src.index_select(axis, g + total * ((S - 1 - g) // total)))


def _adopt_entry(dst: torch.Tensor, src: torch.Tensor, axis: int, dst_total: int,
                 src_total: int, seq, context: bool) -> None:
    """`_adopt_prefill` for one layer's entry (its time axis `axis`) on a
    mesh: the prefill's slice of the S positions gathered over the model
    axis (`seq`) when it holds fewer than `src_total` (one collective), then
    the buffer's own slots filled (a context entry: its rows)."""
    if src.shape[axis] != src_total:
        src = comm.all_gather(src, axis, seq)
    first = dist.get_rank(seq) * dst.shape[axis] if dst.shape[axis] != dst_total else 0
    if context:
        dst.copy_(src.narrow(axis, first, dst.shape[axis]))
    else:
        _put_positions(dst, src, axis, first, dst_total)


def _adopt_prefill(cache: dict, pcache: dict, cfg, mesh=None) -> dict:
    """Copy the prefill cache into the decode buffers, in place, entry by
    entry by name.

    Attention and MLA runs: the prefill KV (S positions) goes into the
    decode buffers (T slots), time axis 2 (L, B, T, ...).  With S <= T
    position p goes to slot p.  A sliding-window arch's buffers are a ring
    of ``T = min(cache_len, window)`` slots (`lm.init_cache`): when S > T,
    the last T positions ``S - T .. S - 1`` go to slots ``p % T``, so that
    after decode's first write (position S at slot ``S % T``) the ring
    holds positions ``S - T + 1 .. S``, exactly the window's keys, which
    `lm.ring_positions(S, T)` names.  The state kinds' entries (no time
    axis) and the context's K / V (``xattn``'s ``k`` / ``v``, ``dec``'s
    ``xk`` / ``xv``: `blocks.CONTEXT_ENTRIES`, sized by `generate` from
    the context input) are copied whole; a shape that differs raises
    `ValueError`.  Each shared-block application's ``k`` / ``v`` (time axis
    1) go to its ring as a full cache's.  A prompt that does not fit
    (`check_prompt_fits`) raises `ValueError`.

    On a `mesh` both caches are a rank's parts (`lm.init_cache(mesh=)`,
    `lm.prefill`'s): each layer's prefill entry, split over "model" or
    whole, is gathered where split (one collective a layer and entry), and
    the rank fills the decode slots it owns with the positions above (the
    context's rows likewise), so that slot p % T lies on its owner.

    This departs from JAX's `_adopt_prefill` (`repro.serve.cv_engine`) in
    three ways, each where JAX keeps a zeroed buffer: a sliding-window ring
    when S > T, where JAX's decode attends to zeros marked valid; a shared
    ring shorter than the prompt, which raises here; and a state or
    context entry whose shape differs, which the port's prefill never makes
    (its conv tail is always K - 1 rows, `models.ssm.conv_tail`; `generate`
    sizes the context entries from the input).  The port is held to JAX's
    `lm.forward` there, not to JAX's `generate`."""
    check_prompt_fits(cache, pcache["pos"], cfg)
    dglob, pglob = cache.get("global"), pcache.get("global")
    if mesh is not None and (dglob is None or pglob is None):
        raise ValueError("_adopt_prefill on a mesh takes init_cache(mesh=)'s and prefill's caches")
    seq = comm.axes_group(mesh, ("model",)) if mesh is not None else None
    for gi, ((kind, _), buf, pre) in enumerate(
            zip(cfg.blocks, cache["groups"], pcache["groups"], strict=True)):
        if set(buf) != set(pre):
            raise ValueError(f"prefill cache entries {sorted(pre)} against {sorted(buf)}")
        state = kind in STATE_KINDS
        context = CONTEXT_ENTRIES.get(kind, ())
        for name in tuple(buf) if state else context:
            a, b = pre[name].shape, buf[name].shape
            if state or seq is None:
                bad = a != b
            else:  # the rows of the context, globally
                bad = (a[:2] + a[3:] != b[:2] + b[3:]
                       or pglob["groups"][gi][name] != dglob["groups"][gi][name])
            if bad:
                raise ValueError(
                    f"{kind} {name}: prefill {tuple(pre[name].shape)} against "
                    f"{tuple(buf[name].shape)}"
                )
        for name, dst in buf.items():
            if state:
                dst.copy_(pre[name])
            elif seq is None:
                if name in context:
                    dst.copy_(pre[name])
                else:
                    _put_positions(dst, pre[name], 2)
            else:
                for li in range(dst.shape[0]):  # one layer at a time
                    _adopt_entry(dst[li], pre[name][li], 1, dglob["groups"][gi][name],
                                 pglob["groups"][gi][name], seq, name in context)
    for i, (buf, pre) in enumerate(
            zip(cache.get("shared", []), pcache.get("shared", []), strict=True)):
        for name, dst in buf.items():
            if seq is None:
                _put_positions(dst, pre[name], 1)
            else:
                _adopt_entry(dst, pre[name], 1, dglob["shared"][i][name],
                             pglob["shared"][i][name], seq, False)
    return dict(cache, pos=pcache["pos"])


# ---------------------------------------------------------------------------
# smoke workload (JAX's): 16 mixed frames and one of bad rank
# ---------------------------------------------------------------------------


def _smoke(verbose: bool = True, device=None) -> int:
    """Mixed-shape workload through the engine under whatever
    ``REPRO_TORCH_FAULT_SPEC`` is active; returns non-zero on any
    unexpected failure."""
    dev = resolve_device(device)
    gen = np.random.default_rng(7)
    work = []
    for i in range(16):
        h, w = int(gen.integers(24, 40)), int(gen.integers(24, 40))
        if i % 3 == 0:
            work.append(gen.random((h, w), dtype=np.float32))
        else:
            work.append(gen.integers(0, 256, (h, w, 3), dtype=np.uint8))
    work.append(np.zeros((8, 8, 2), dtype=np.uint8))        # bad rank -> error
    mesh = None
    if dev.type == "cuda" and torch.cuda.device_count() > 1:  # shard the fan-out
        from ..launch.mesh import make_cv_mesh
        mesh = make_cv_mesh(device=dev)
    eng = CvEngine(buckets=((32, 32), (48, 48)), max_batch=8, max_kp=16, mesh=mesh,
                   device=dev)
    faultinject.clear_degradation_log()
    res = eng.extract(work)
    n_ok = sum(r.ok for r in res)
    n_err = sum(not r.ok for r in res)
    n_deg = sum(r.degraded for r in res)
    problems = []
    if any(r is None for r in res):
        problems.append("unanswered request")
    if n_ok != len(work) - 1:
        problems.append(f"expected every well-formed request served, got {n_ok}/{len(work) - 1}: "
                        f"{[r.error for r in res[:-1] if not r.ok]}")
    if res[-1].ok or "bad_rank" not in (res[-1].error or ""):
        problems.append(f"the bad-rank frame was not refused: {res[-1]}")
    if verbose:
        spec = faultinject.registry()
        print(f"serve-smoke ({dev}): {n_ok} ok / {n_err} rejected / {n_deg} degraded; "
              f"{len(faultinject.degradation_log())} degradation events; "
              f"faults={'on (' + ','.join(spec.specs) + ')' if spec else 'off'}")
        print(f"stats: {eng.stats}")
        if eng.dispatcher is not None:
            d = eng.dispatcher
            print(f"shards: {d.stats}; lost={d.lost_devices()}; "
                  f"quarantined={d.health.quarantined()}")
        for p in problems:
            print(f"serve-smoke FAILED: {p}")
    return 1 if problems else 0


if __name__ == "__main__":  # python -m repro_torch.serve.cv_engine --smoke [--device cpu]
    import argparse

    ap = argparse.ArgumentParser(description="CV serving engine tools")
    ap.add_argument("--smoke", action="store_true",
                    help="run the mixed-shape smoke workload (honours REPRO_TORCH_FAULT_SPEC) "
                         "and exit non-zero on failure")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = ap.parse_args()
    if a.smoke:
        raise SystemExit(_smoke(device=a.device))
