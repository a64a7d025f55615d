"""Pluggable batched serving engine with paged or dense KV.

Port of ``repro.serve.engine``.  One fixed-shape decode step serves all slots
every tick; admission between ticks is delegated to a swappable
:class:`~repro_torch.serve.scheduler.Scheduler`; prompt ingestion runs as
*chunked batched prefill* — one ``ModelApi.decode_chunk`` call per chunk,
shared across every slot admitted that tick.  Every tick is measured into
:class:`~repro_torch.serve.metrics.EngineMetrics`.

The reference jits its steps under the engine's kernel policy; here each
step is a closure that enters the engine's ``kernel_policy(backend=...,
autotune=..., guard=...)`` on every call, and "re-jitting" a step means
re-binding its closure.  One engine definition therefore runs the ``cuda``
and ``torch`` paths side by side.  The steps run on the model's device (the
card unless the model was built with ``device="cpu"``).

The dense family's steps are plain torch ops (as the reference's are plain
jnp) and launch no hand kernel, so on this port the options that choose
between kernel paths — ``backend``, ``autotune``, ``degrade``, ``guard``,
``guard_sample``, ``guard_cooldown`` — and the shadow twins, attribution and
re-binding behind them choose between identical computations: a shadow
check compares torch with torch.  They are kept for the reference's API and
its fault-injection tests, and start to matter once a step launches a hand
kernel (a CUDA-graph-captured or kernel-routed step, ROADMAP.md §1 item 8).
The steps update the KV cache in place (the reference donates its buffer);
a shadow-checked tick hands the torch twin its own copy of the cache.

Two KV layouts (see ``docs/serving.md`` for the architecture guide):

- **dense** (``page_size=None``) — each slot reserves a contiguous
  ``max_len`` KV region; memory is ``n_slots * max_len`` regardless of the
  actual sequence lengths.
- **paged** (``page_size=N``) — KV lives in a global pool of fixed-size
  pages (``repro_torch.models.attention``); each lane holds an ordered page
  list (its *block table* row) and the host-side
  :class:`~repro_torch.serve.paging.PageAllocator` tracks ownership.
  Admission is page-aware, finished requests return their pages to the pool
  the same tick, a lane that outgrows its pages triggers *recompute
  preemption* of the lowest-priority latest-admitted lane, and prompts
  sharing a :meth:`ServeEngine.register_prefix` prefix reference the same
  physical pages copy-on-write.

Correctness invariants the paged path maintains:

- gathering a lane's pages reproduces its dense cache exactly, so paged and
  dense decode are token-for-token identical for the same requests (bit for
  bit when the block table spans ``max_len``: the gathered view then has
  the dense cache's length),
- a page referenced by more than one owner (another lane or the prefix
  registry) is never written: forks copy the boundary page before their
  first write (CoW at page granularity),
- empty/finished lanes carry the pad position sentinel (``T*page``), which
  writes nothing — a pad lane can never scribble on a live lane's pages.

Robustness: ``submit(deadline_s=)`` bounds a request's wall-clock, every
re-queue of drained/preempted/quarantined work goes through the budgeted
:meth:`ServeEngine.requeue`, non-finite logits quarantine the lane and retry
the session (token-exact), and a step failure on the ``cuda`` path is
attributed to a kernel op by the numerics guard first (``EngineConfig.guard``
— per-op quarantine to the torch oracle, breaker-style cooldown/revival,
shadow-oracle drift checks of the steps), falling back to the whole-engine
one-shot ``torch`` degrade (``EngineConfig.degrade``, off by default) only
when no op is implicated.  The ``crashed`` / ``step_time_scale`` attributes
and ``_inject_step_error`` / ``_inject_nan_lanes`` / ``_inject_drift`` are
the deterministic fault-injection surface.  On the card only an injected
failure or drift may reach these fallbacks: a real one re-raises, whatever
``degrade`` says, so no torch path can hide a failing kernel there.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import guard as kguard
from repro_torch.kernels.api import BACKENDS, current_policy, default_backend, kernel_policy
from repro_torch.models.api import ModelApi

from .metrics import EngineMetrics
from .paging import PageAllocator, PagePoolExhausted, SharedPrefix
from .sampler import greedy
from .scheduler import Scheduler, make_scheduler
from .session import (
    ACTIVE,
    FINISH_CANCELLED,
    FINISH_DEADLINE,
    FINISH_EOS,
    FINISH_MAX_LEN,
    FINISH_MAX_NEW_TOKENS,
    PREFILL,
    QUEUED,
    Session,
)


#: Model families whose caches are plain attention KV and therefore serve
#: through the batched engine.  Recurrent families (ssm/xlstm/hybrid) carry
#: per-lane conv/ssm state that cannot yet advance independently inside a
#: shared batch.
SERVABLE_FAMILIES = ("dense", "moe", "vlm")


class UnsupportedFamilyError(NotImplementedError):
    """A model family the engine cannot serve (no ``decode_chunk`` path).

    ``family`` is the offending ``ModelConfig.family``; ``missing`` is the
    ``ModelApi`` capability that is ``None`` for it.
    """

    def __init__(self, family: str, missing: str = "decode_chunk"):
        self.family = family
        self.missing = missing
        super().__init__(
            f"model family {family!r} has no {missing}: recurrent per-lane "
            "state cannot yet advance independently inside a shared batch; "
            f"serve one of the dense-cache families {SERVABLE_FAMILIES} "
            "instead (see the ROADMAP per-lane state isolation item)"
        )


class ReplicaCrashed(RuntimeError):
    """The engine's (simulated) process is down: ``step()`` refuses to run.

    Raised at the very top of :meth:`ServeEngine.step` while the ``crashed``
    flag is set — before any host bookkeeping mutates, so the engine's state
    stays consistent and a later revival resumes cleanly.
    """


class RetryBudgetExceeded(RuntimeError):
    """A session was re-queued more times than ``EngineConfig.retry_budget``.

    Raised from :meth:`ServeEngine.requeue` instead of silently looping a
    session through drain/preempt/quarantine forever.  ``session`` is the
    offending request (its partial output is intact).
    """

    def __init__(self, session: Session, budget: int):
        self.session = session
        self.budget = budget
        super().__init__(
            f"session {session.rid} re-queued {session.stats.requeues} times, "
            f"over retry_budget={budget}; partial output "
            f"({len(session.out)} tokens) is intact on the session handle"
        )


@dataclass(frozen=True)
class EngineConfig:
    """Engine-level knobs, separated from the model definition.

    ``backend``/``autotune``/``guard`` scope a ``kernel_policy`` around every
    call of the engine's steps, so the same engine definition can run every
    kernel path of a model whose config selects kernel-routed
    implementations (``attn_impl="pallas"``).

    Fields:

    - ``n_slots`` — lanes in the batch (the decode step's B).
    - ``max_len`` — logical cap on prompt+generated length per request.
    - ``prefill_chunk`` — tokens per prefill step (a smaller chunk
      interleaves admission with decode sooner; a larger one amortizes
      dispatch, and its logits are (n_slots, prefill_chunk, vocab)).
    - ``page_size`` — KV slots per page.  ``None`` selects the dense layout.
    - ``n_pages`` — page-pool size.  Defaults to
      ``n_slots * ceil(max_len / page_size)`` (worst case: every lane at
      ``max_len`` — same memory as dense).  Set it *lower* to oversubscribe
      slots against real memory.  Must hold at least one worst-case lane.
    - ``backend`` / ``autotune`` — kernel policy scoped around the steps
      (``None``: ambient policy; the backend then follows the model's device).
    - ``mesh`` — tensor-parallel decode; only ``None`` (one device) runs in
      the port so far (ROADMAP.md §1 item 11).
    - ``eos_id`` — sampled token that finishes a request early.
    - ``sampler`` — logits -> token function (greedy default).
    - ``scheduler`` — stock admission policy name used when no
      :class:`Scheduler` instance is injected.
    - ``retry_budget`` / ``retry_backoff`` — bounds on the requeue loop for
      drained/preempted/quarantined sessions: over-budget requeues raise the
      typed :class:`RetryBudgetExceeded`; a nonzero backoff delays the n-th
      re-admission by ``retry_backoff * 2**(n-1)`` engine ticks.
    - ``quarantine_ticks`` — ticks a lane stays out of admission after its
      logits failed the NaN/Inf guard.
    - ``nan_guard`` — check sampled logits rows for non-finite values and
      quarantine + retry instead of emitting garbage tokens.
    - ``degrade`` — on a step failure under the ``cuda`` backend, fall back
      once to the ``torch`` backend (token-identical) instead of failing the
      whole engine; a second failure re-raises.  Off by default; on the card
      only an injected failure may fall back.
    - ``guard`` — numerics-guard mode for the steps: ``None`` inherits the
      ambient ``kernel_policy`` guard, ``"off"`` disables, ``"sample"``
      shadow-checks every ``guard_sample``-th step output against a torch
      twin, ``"shadow"`` checks every one.  A drifting step attributes to a
      kernel op via ``repro_torch.kernels.guard`` and quarantines *that op*
      to the oracle (whole-engine ``degrade`` stays the fallback when
      attribution fails); the drifting tick is served from the shadow
      output, keeping the token stream exact.
    - ``guard_sample`` — step sampling stride under ``guard="sample"``.
    - ``guard_cooldown`` — engine ticks a quarantined op waits before its
      half-open re-probe (doubling per consecutive failure, capped at 16x).
    """

    n_slots: int
    max_len: int
    prefill_chunk: int = 16  # tokens per prefill step
    page_size: Optional[int] = None  # None: dense per-slot KV regions
    n_pages: Optional[int] = None  # pool size (None: worst-case default)
    backend: Optional[str] = None  # kernel_policy backend (None: ambient)
    # kernel_policy autotune for engine steps (None: ambient; bool: forced)
    autotune: Optional[bool] = None
    mesh: Optional[Any] = None  # tensor-parallel mesh (None: single device)
    eos_id: Optional[int] = None
    sampler: Callable = greedy
    scheduler: str = "fcfs"  # default policy when none is injected
    retry_budget: int = 64  # max requeues per session before the typed error
    retry_backoff: int = 0  # base backoff in ticks (0: immediate re-admission)
    quarantine_ticks: int = 4  # lane bench time after a NaN-guard trip
    nan_guard: bool = True  # quarantine lanes with non-finite logits
    degrade: bool = False  # cuda step failure -> one-shot torch fallback
    guard: Optional[str] = None  # numerics-guard mode (None: ambient policy)
    guard_sample: int = 8  # shadow-check stride under guard="sample"
    guard_cooldown: int = 8  # ticks before a quarantined op re-probes

    def __post_init__(self):
        if self.retry_budget < 1:
            raise ValueError("retry_budget must be >= 1")
        if self.retry_backoff < 0:
            raise ValueError("retry_backoff must be >= 0 ticks")
        if self.quarantine_ticks < 0:
            raise ValueError("quarantine_ticks must be >= 0")
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.max_len < 2:
            raise ValueError("max_len must be >= 2 (prompt + one generated token)")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected {BACKENDS}")
        if self.guard is not None and self.guard not in kguard.GUARD_MODES:
            raise ValueError(
                f"unknown guard mode {self.guard!r}; expected {kguard.GUARD_MODES}"
            )
        if self.guard_sample < 1:
            raise ValueError("guard_sample must be >= 1")
        if self.guard_cooldown < 1:
            raise ValueError("guard_cooldown must be >= 1 tick")
        if self.page_size is not None and self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.n_pages is not None:
            if self.page_size is None:
                raise ValueError("n_pages requires page_size (paged mode)")
            min_pages = -(-self.max_len // self.page_size)
            if self.n_pages < min_pages:
                raise ValueError(
                    f"n_pages={self.n_pages} cannot hold one worst-case lane "
                    f"(max_len {self.max_len} needs {min_pages} pages of "
                    f"{self.page_size})"
                )

    @property
    def table_width(self) -> int:
        """Block-table row length: pages needed for one ``max_len`` lane."""
        if self.page_size is None:
            raise ValueError("table_width is a paged-mode property")
        return -(-self.max_len // self.page_size)


class ServeEngine:
    """Continuous-batching engine over a fixed slot grid.

    ``scheduler`` accepts any :class:`Scheduler` implementation (defaults to
    the config's named stock policy); ``submit`` returns a streaming
    :class:`Session` handle with per-token callbacks, cancellation, and
    request stats.  With ``EngineConfig.page_size`` set, KV is paged (see the
    module docstring): ``register_prefix`` stores a common prompt prefix
    once, admission waits on pages rather than failing, and pool exhaustion
    mid-decode preempts (re-queues) lanes instead of corrupting them.
    """

    def __init__(self, model: ModelApi, params, config: EngineConfig,
                 scheduler: Optional[Scheduler] = None):
        if model.decode_chunk is None:
            raise UnsupportedFamilyError(model.cfg.family)
        self.paged = config.page_size is not None
        if self.paged and (model.decode_step_paged is None
                           or model.decode_chunk_paged is None):
            raise UnsupportedFamilyError(model.cfg.family, missing="decode_chunk_paged")
        if config.mesh is not None:
            raise NotImplementedError(
                "EngineConfig.mesh: tensor-parallel serving waits for the port's "
                "distribution layer (ROADMAP.md §1 item 11); pass mesh=None"
            )
        self.model = model
        self.device = torch.device(model.device)
        self.params = params
        self.cfg = config
        self.scheduler = scheduler if scheduler is not None else make_scheduler(config.scheduler)
        if not isinstance(self.scheduler, Scheduler):
            raise TypeError(
                f"scheduler {type(self.scheduler).__name__} does not implement "
                "the Scheduler protocol (submit/select/pending)"
            )
        self.slots: list = [None] * config.n_slots
        self.finished: list = []
        self.last_token = torch.zeros((config.n_slots,), dtype=torch.int32, device=self.device)
        self._lane_pos = [0] * config.n_slots  # host mirror: next cache index
        self._rid = 0
        # -- robustness state ---------------------------------------------
        self.tick = 0  # monotonically increasing step counter
        self.last_step_s = 0.0  # scaled duration of the most recent step()
        # the most recent step() re-bound its steps (quarantine, revival,
        # degradation): a health monitor must not score that step's time
        self.last_step_recompiled = False
        self._recompiled = False
        # fault-injection surface:
        self.crashed = False  # step() raises ReplicaCrashed while set
        self.step_time_scale = 1.0  # virtual dilation of reported step times
        self._inject_step_error: Optional[Exception] = None  # raised pre-decode
        self._inject_nan_lanes: set = set()  # lanes whose logits are poisoned
        # hardening state:
        self._degraded = False  # steps fell back to the torch backend
        self._quarantined: dict = {}  # lane -> first tick it is usable again
        # numerics-guard state; the mode must resolve before the steps bind
        # so they run with the guard in their kernel policy
        self._guard_mode = (config.guard if config.guard is not None
                            else (current_policy().guard or "off"))
        self._shadow_decode = None  # lazy torch twins of the steps
        self._shadow_chunk = None
        self._guard_calls = 0  # step counter (sampling stride)
        self._op_quarantine: dict = {}  # op -> {"since": tick, "fails": n}
        self._nan_attr_tick = -1  # last tick NaN attribution ran (once/tick)
        # fault surface: seeded logits perturbation standing in for a
        # drifting kernel inside the step
        self._inject_drift: Optional[dict] = None  # {"op","scale","rng"}
        self._injected_drift_calls = 0
        if self.paged:
            ps = config.page_size
            self._table_width = config.table_width
            self.n_pages = (config.n_pages if config.n_pages is not None
                            else config.n_slots * self._table_width)
            # pad sentinel: one past the last addressable pool-view slot, so
            # pad lanes/entries write nothing and mask as "see everything"
            self._pad_pos = self._table_width * ps
            self.allocator = PageAllocator(self.n_pages, ps)
            self.page_tables: list = [[] for _ in range(config.n_slots)]
            self._bt = np.zeros((config.n_slots, self._table_width), np.int32)
            self._prefixes: dict = {}  # token tuple -> SharedPrefix
            self.cache = model.init_paged_cache(self.n_pages, ps)
        else:
            self.n_pages = 0
            self._pad_pos = config.max_len
            self.cache = model.init_cache(config.n_slots, config.max_len)
        self._decode, self._chunk = self._bind_steps()
        self.pos = torch.full((config.n_slots,), self._pad_pos if self.paged else 0,
                              dtype=torch.int32, device=self.device)
        self.metrics = EngineMetrics(config.n_slots, n_pages=self.n_pages)

    # ------------------------------------------------------------------
    def _step_fns(self) -> tuple:
        """The model's (decode, chunk) functions for this engine's layout."""
        m = self.model
        if self.paged:
            return m.decode_step_paged, m.decode_chunk_paged
        return m.decode_step, m.decode_chunk

    def _scoped(self, fn: Callable, backend: Optional[str] = None) -> Callable:
        """``fn`` bound to the config's kernel policy: a fresh closure that
        enters ``kernel_policy(backend=..., autotune=..., guard=...)`` on
        every call.  Its first call marks the tick as re-bound (the
        reference's trace-time marker).

        ``backend`` overrides the config's backend — the graceful-degradation
        path re-binds the steps with ``backend="torch"`` after a failure.
        """
        backend = self.cfg.backend if backend is None else backend
        guard = self._guard_mode if self._guard_mode != "off" else None
        autotune = self.cfg.autotune
        first = [True]

        def scoped(*args):
            if first[0]:
                first[0] = False
                self._recompiled = True
            with kernel_policy(backend=backend, autotune=autotune, guard=guard):
                return fn(*args)

        return scoped

    def _bind_steps(self, backend: Optional[str] = None) -> tuple:
        decode, chunk = self._step_fns()
        return self._scoped(decode, backend), self._scoped(chunk, backend)

    # ------------------------------------------------------------------
    # graceful degradation
    # ------------------------------------------------------------------
    def _backend(self) -> str:
        """Effective kernel backend of the steps right now."""
        if self._degraded:
            return "torch"
        if self.cfg.backend is not None:
            return self.cfg.backend
        return current_policy().backend or default_backend(self.device)

    @property
    def op_quarantined(self) -> bool:
        """Any kernel op currently quarantined to the oracle backend.  Step
        times are not fleet-comparable while set (part of the engine runs on
        a different backend)."""
        return bool(self._op_quarantine)

    def _rejit_steps(self, backend: Optional[str] = None) -> None:
        """Re-bind both steps (per-op quarantine / revival / whole-engine
        degradation all change what a fresh step dispatches to); the lazy
        shadow twins rebuild on next use."""
        self._recompiled = True
        self._decode, self._chunk = self._bind_steps(backend)
        self._shadow_decode = self._shadow_chunk = None

    def _degrade(self, err: Exception) -> None:
        """Whole-engine fallback: re-bind decode/prefill on the ``torch``
        backend.  With the numerics guard on this is the *second* line of
        defense — per-op attribution runs first (:meth:`_guard_attribute`).

        Backend parity (the kernels' correctness contract) makes the
        degraded engine token-identical — only kernel dispatch changes, so
        in-flight lanes continue from the same cache without replay."""
        self._degraded = True
        self.metrics.record_degradation()
        self._rejit_steps(backend="torch")
        warnings.warn(
            f"serving engine degraded to the torch backend after a step "
            f"failure: {err!r}",
            RuntimeWarning,
            stacklevel=4,
        )

    # -- numerics guard --------------------------------------------------
    def _injected(self, err: Exception) -> bool:
        """Whether a step failure comes from the fault-injection surface (the
        engine's injected step error, or a guard injection on the op it
        names).  On the card only such a failure may reach a torch fallback."""
        op = getattr(err, "op", None)
        return (err is self._inject_step_error
                or (op is not None and kguard.has_injection(op)))

    def _may_fall_back(self, injected: bool) -> bool:
        """Whether a failure may reach attribution, quarantine or degrade."""
        return injected or self.device.type != "cuda"

    def _op_suppressed(self, err: Exception) -> bool:
        """An injected step error attributed to an op stops firing once that
        op is quarantined — the retried step runs with the op on the oracle."""
        op = getattr(err, "op", None)
        return op is not None and kguard.is_quarantined(op)

    def _perturb(self, out):
        """Apply an injected ``kernel_drift`` fault: seeded additive noise on
        the step's logits (drawn on the host by numpy, as the reference
        draws it), standing in for a drifting kernel inside the step.
        Quarantining the named op (which routes it to the oracle) ends the
        perturbation, like a real per-op degrade would."""
        inj = self._inject_drift
        if (inj is None or self._backend() == "torch"
                or kguard.is_quarantined(inj["op"])):
            return out
        logits = out[0]
        arr = logits.double()
        noise = torch.from_numpy(inj["rng"].standard_normal(tuple(arr.shape)))
        scale = inj["scale"] * (float(arr.abs().mean()) + 1.0)
        self._injected_drift_calls += 1
        perturbed = (arr + noise.to(arr.device) * scale).to(logits.dtype)
        return (perturbed,) + tuple(out[1:])

    def _guard_attribute(self, err: Exception, injected: bool = False) -> bool:
        """Attribute a step failure/drift to specific kernel ops via the
        guard's canonical probes; quarantined ops re-bind the steps so they
        route them to the oracle.  False means no op was implicated (the
        caller falls back to whole-engine handling)."""
        if self._guard_mode == "off":
            return False
        bad = kguard.attribute()
        hinted = getattr(err, "op", None)
        if (hinted is not None and hinted not in bad
                and not kguard.is_quarantined(hinted)):
            kguard.quarantine(hinted, f"engine attribution: {err!r}", injected=injected)
            bad.append(hinted)
        if not bad:
            return False
        for op in bad:
            rec = self._op_quarantine.setdefault(op, {"since": self.tick, "fails": 0})
            rec["since"] = self.tick
            rec["fails"] += 1
        self.metrics.record_op_degradation(len(bad))
        warnings.warn(
            f"numerics guard quarantined kernel op(s) {sorted(bad)} to the "
            f"torch backend (engine stays on {self._backend()!r}): {err!r}",
            RuntimeWarning,
            stacklevel=5,
        )
        self._rejit_steps()
        return True

    def _heal_ops(self) -> None:
        """Half-open re-probe for quarantined ops whose cooldown elapsed:
        a clean canonical probe revives the op (the steps dispatch native
        again); a dirty one doubles the cooldown."""
        healed = False
        for op, rec in list(self._op_quarantine.items()):
            wait = self.cfg.guard_cooldown * 2 ** min(rec["fails"] - 1, 4)
            if self.tick - rec["since"] < wait:
                continue
            if kguard.probe(op):
                kguard.revive(op)
                del self._op_quarantine[op]
                self.metrics.record_op_revival()
                healed = True
            else:
                rec["since"] = self.tick
                rec["fails"] += 1
        if healed:
            self._rejit_steps()

    def _shadow_fn(self, which: str) -> Callable:
        """Lazy torch-backed twin of a step (the shadow oracle): the same
        step under ``kernel_policy(backend="torch")``."""
        decode, chunk = self._step_fns()
        if which == "decode":
            if self._shadow_decode is None:
                self._shadow_decode = self._scoped(decode, backend="torch")
            return self._shadow_decode
        if self._shadow_chunk is None:
            self._shadow_chunk = self._scoped(chunk, backend="torch")
        return self._shadow_chunk

    def _guard_due(self) -> bool:
        """Whether the next step that succeeds is shadow-checked."""
        if self._guard_mode == "off" or self._backend() == "torch":
            return False
        return (self._guard_mode == "shadow"
                or (self._guard_calls + 1) % self.cfg.guard_sample == 0)

    def _shadow_args(self, args: tuple) -> Optional[tuple]:
        """The torch twin's arguments for a tick whose check is due (None
        otherwise): the same arguments with a copy of the cache, which the
        step itself updates in place."""
        if not self._guard_due():
            return None
        cache = {k: v.clone() for k, v in args[1].items()}
        return args[:1] + (cache,) + args[2:]

    def _guard_verify(self, which: str, shadow_args: Optional[tuple], out,
                      injected: bool):
        """Shadow-oracle check of a step output: re-run the step's
        arguments (``shadow_args``, set when a check is due) through the
        torch twin and compare under the per-dtype tolerance ladder of the
        guard's configured part.  On drift, attribute to a kernel op
        (falling back to whole-engine degrade) and serve the *shadow* output
        for this tick — the token stream stays exact while the quarantine
        takes effect.  On the card a drift that was not injected raises."""
        if self._guard_mode == "off" or self._backend() == "torch":
            return out
        self._guard_calls += 1
        if shadow_args is None:
            return out
        shadow = self._shadow_fn(which)(*shadow_args)
        self.metrics.record_guard_check()
        ok, detail = kguard.trees_match(out, shadow, hw=kguard.state().config.hw)
        if ok:
            return out
        self.metrics.record_drift_event()
        err = RuntimeError(
            f"{which} step drifted from its torch shadow: {detail}"
        )
        if not self._may_fall_back(injected):
            raise err
        if not self._guard_attribute(err, injected):
            if self.cfg.degrade:
                self._degrade(err)
            else:
                raise err
        return shadow

    def _call_compiled(self, which: str, *args):
        """Run a step with the guard and degradation boundaries around it.

        A failure attributes to a kernel op first (per-op quarantine + retry
        with the op on the oracle); only when attribution finds nothing does
        the whole-engine :meth:`_degrade` fallback fire (or the failure
        re-raise, with ``degrade=False`` or already on torch).  Successful
        outputs pass through the shadow-oracle check of
        :meth:`_guard_verify`.
        """
        while True:
            fn = self._decode if which == "decode" else self._chunk
            shadow_args = self._shadow_args(args)
            try:
                inj = self._inject_step_error
                if (inj is not None and self._backend() != "torch"
                        and not self._op_suppressed(inj)):
                    raise inj
                out = fn(*args)
                drifts_before = self._injected_drift_calls
                out = self._perturb(out)
            except Exception as err:  # guard/degradation boundary
                injected = self._injected(err)
                if not self._may_fall_back(injected):
                    raise  # a real failure on the card: no torch path hides it
                if self._guard_attribute(err, injected):
                    continue  # op quarantined + steps re-bound: retry
                if not self.cfg.degrade or self._backend() == "torch":
                    raise
                self._degrade(err)
                continue
            return self._guard_verify(which, shadow_args, out,
                                      self._injected_drift_calls > drifts_before)

    # ------------------------------------------------------------------
    def _device_ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def _set_pos(self, lane: int, value: int) -> None:
        pos = self.pos.clone()
        pos[lane] = value
        self.pos = pos

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               on_token: Optional[Callable] = None,
               deadline_s: Optional[float] = None) -> Session:
        """Queue a request; returns its streaming :class:`Session` handle.

        ``deadline_s`` bounds the request's wall-clock from this call: a
        session that is still queued or generating when the deadline passes
        finishes with ``finish_reason="deadline"`` and whatever output it
        has (the goodput metrics exclude its tokens).
        """
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.cfg.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} must be < max_len "
                f"{self.cfg.max_len} (no room to generate)"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        session = Session(self._rid, prompt, max_new_tokens,
                          priority=priority, on_token=on_token,
                          deadline_s=deadline_s)
        session.stats.submitted_at = time.perf_counter()
        session._on_queued_cancel = self._record_queued_cancel
        self._rid += 1
        self.scheduler.submit(session)
        return session

    def requeue(self, session: Session) -> None:
        """Budgeted re-queue for drained / preempted / quarantined sessions.

        The n-th requeue beyond ``retry_budget`` raises
        :class:`RetryBudgetExceeded`; with ``retry_backoff > 0`` re-admission
        is delayed exponentially (``backoff * 2**(n-1)`` ticks, capped at
        64x).  Paged pool-misfit waits in admission deliberately do **not**
        count — they recur every tick for a merely-waiting request and carry
        no failure signal.
        """
        session.stats.requeues += 1
        self.metrics.record_requeue()
        if session.stats.requeues > self.cfg.retry_budget:
            raise RetryBudgetExceeded(session, self.cfg.retry_budget)
        if self.cfg.retry_backoff:
            wait = self.cfg.retry_backoff * 2 ** min(session.stats.requeues - 1, 6)
            session._backoff_until = self.tick + wait
        session.status = QUEUED
        session._on_queued_cancel = self._record_queued_cancel
        self.scheduler.submit(session)

    def _record_queued_cancel(self, session: Session) -> None:
        """Queued-cancel accounting: the session never occupies a slot, but
        it must still show up in metrics and the finished list."""
        self.metrics.record_finished(session)
        self.finished.append(session)

    def cancel(self, session: Session) -> None:
        """Alias for ``session.cancel()`` (kept for symmetry with submit)."""
        session.cancel()

    # ------------------------------------------------------------------
    # shared prefixes (paged mode)
    # ------------------------------------------------------------------
    def register_prefix(self, tokens) -> SharedPrefix:
        """Prefill ``tokens`` once into pool pages shared by every future
        request whose prompt starts with them (paged mode only).

        The registry holds a permanent reference on the pages, so they
        survive any individual session; forking sessions re-use the KV for
        all but (at least) the final prompt token and only prefill their
        suffix.  Registration itself runs outside the serving metrics.
        """
        if not self.paged:
            raise ValueError("register_prefix requires paged KV (set page_size)")
        tokens = tuple(int(t) for t in tokens)
        if not tokens:
            raise ValueError("empty prefix")
        if len(tokens) >= self.cfg.max_len:
            raise ValueError("prefix must be shorter than max_len")
        if tokens in self._prefixes:
            return self._prefixes[tokens]
        n_t = self.allocator.pages_for(len(tokens))
        if (not self.allocator.can_alloc(n_t)
                or self.allocator.free_pages - n_t < self._table_width):
            raise PagePoolExhausted(
                f"prefix of {len(tokens)} tokens needs {n_t} pages and the "
                f"pool must keep {self._table_width} pages of headroom for "
                f"one worst-case lane ({self.allocator.free_pages} free)"
            )
        pages = self.allocator.alloc(n_t)
        # Prefill the prefix KV through a temporary block-table view: row 0
        # maps to the prefix pages, every other row is pad (writes nothing,
        # reads garbage logits nobody samples) — live lanes are untouched
        # because writes target pool positions, not lanes.
        chunk = self.cfg.prefill_chunk
        bt = self._bt.copy()
        bt[0, :] = 0
        bt[0, :n_t] = pages
        n_chunks = -(-len(tokens) // chunk)
        toks = np.zeros((self.cfg.n_slots, n_chunks * chunk), np.int32)
        poss = np.full((self.cfg.n_slots, n_chunks * chunk), self._pad_pos, np.int32)
        toks[0, : len(tokens)] = tokens
        poss[0, : len(tokens)] = np.arange(len(tokens), dtype=np.int32)
        bt_dev = self._device_ints(bt)
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            _, self.cache = self._chunk(
                self.params, self.cache, bt_dev,
                self._device_ints(toks[:, sl]), self._device_ints(poss[:, sl]),
            )
        prefix = SharedPrefix(tokens=tokens, pages=pages)
        self._prefixes[tokens] = prefix
        return prefix

    def unregister_prefix(self, tokens) -> None:
        """Drop a registered prefix: the registry's page references are
        released (pages free once no lane still shares them)."""
        prefix = self._prefixes.pop(tuple(int(t) for t in tokens))
        self.allocator.free(prefix.pages)

    def _fork_plan(self, feed: list) -> tuple:
        """Longest registered prefix under ``feed`` -> (prefix, reuse) where
        ``reuse`` positions of KV are taken from shared pages instead of
        being re-prefilled.  At least the final feed token is always re-fed
        so the fork has a logits row to sample from."""
        best, reuse = None, 0
        for prefix in self._prefixes.values():
            n = min(len(prefix.tokens), len(feed) - 1)
            if n > reuse and feed[: len(prefix.tokens)] == list(prefix.tokens):
                best, reuse = prefix, n
        return best, reuse

    # ------------------------------------------------------------------
    # paged bookkeeping
    # ------------------------------------------------------------------
    def _set_lane_pages(self, lane: int, pages: list) -> None:
        self.page_tables[lane] = pages
        self._bt[lane, :] = 0
        self._bt[lane, : len(pages)] = pages

    def _copy_page(self, src: int, dst: int) -> None:
        """Device-side page copy (all layers), in place on the pool: the CoW
        step of a fork."""
        for pool in self.cache.values():
            pool[:, dst] = pool[:, src]

    def _release_lane(self, lane: int) -> None:
        """Return a lane's pages to the pool and pad the lane out."""
        if self.paged:
            self.allocator.free(self.page_tables[lane])
            self._set_lane_pages(lane, [])
        self.slots[lane] = None
        self._set_pos(lane, self._pad_pos if self.paged else 0)

    def _try_admit_paged(self, lane: int, session: Session) -> Optional[tuple]:
        """Build the lane's page table for ``session`` (sharing a registered
        prefix when one matches); returns the prefill assignment or None if
        the pool cannot hold the request right now."""
        feed = session.prompt + session.out  # out non-empty: preempted resume
        ps = self.cfg.page_size
        n_t = self.allocator.pages_for(len(feed))
        prefix, reuse = self._fork_plan(feed)
        m = reuse // ps  # fully-shared pages (never written by this lane)
        cow = reuse % ps != 0  # boundary page: preserved KV + this lane's writes
        if not self.allocator.can_alloc(n_t - m):
            return None
        fresh = self.allocator.alloc(n_t - m)
        shared = prefix.pages[:m] if prefix is not None else []
        if shared:
            self.allocator.share(shared)
        self._set_lane_pages(lane, shared + fresh)
        if cow:
            # copy-on-write: page m holds prefix KV at positions
            # [m*ps, reuse) that this lane reuses but must not share,
            # because its own writes start inside the same page
            self._copy_page(prefix.pages[m], fresh[0])
        if prefix is not None and reuse:
            prefix.hits += 1
            self.metrics.record_prefix_hit(reuse)
        return (lane, session, feed, reuse if prefix is not None else 0)

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Preemption victim: lowest priority, then latest admitted."""
        candidates = [
            (s.priority, -(s.stats.admitted_at or 0.0), i)
            for i, s in enumerate(self.slots)
            if s is not None and i != exclude
        ]
        if not candidates:
            return None
        return min(candidates)[2]

    def _preempt(self, lane: int) -> None:
        """Recompute preemption: evict the lane, free its pages, and
        re-queue the session.  On re-admission the engine replays
        prompt+output through prefill, which reconstructs the KV exactly —
        the stream resumes with no lost or corrupted tokens."""
        session = self.slots[lane]
        self._release_lane(lane)
        session.stats.preemptions += 1
        self.metrics.record_preemption()
        self.requeue(session)

    def _grow_lane(self, lane: int) -> bool:
        """Ensure the lane owns the page its next KV write lands in,
        preempting other lanes (or, last resort, this one) when the pool is
        exhausted.  Returns False if the lane itself was evicted."""
        ps = self.cfg.page_size
        while len(self.page_tables[lane]) < self._lane_pos[lane] // ps + 1:
            while not self.allocator.can_alloc(1):
                victim = self._pick_victim(exclude=lane)
                if victim is None:
                    self._preempt(lane)
                    return False
                self._preempt(victim)
            page = self.allocator.alloc(1)[0]
            pages = self.page_tables[lane]
            self._set_lane_pages(lane, pages + [page])
        return True

    # ------------------------------------------------------------------
    def _finalize(self, lane: int, session: Session, reason: str) -> None:
        session._finish(reason)
        self.metrics.record_finished(session)
        self.finished.append(session)
        self._release_lane(lane)

    def _finish_reason(self, lane: int, session: Session, token: int) -> str:
        if self.cfg.eos_id is not None and token == self.cfg.eos_id:
            return FINISH_EOS
        if len(session.out) >= session.max_new_tokens:
            return FINISH_MAX_NEW_TOKENS
        if self._lane_pos[lane] >= self.cfg.max_len:
            return FINISH_MAX_LEN  # cache exhausted: nowhere to write the next KV
        return ""

    def _release_cancelled(self) -> None:
        for i, s in enumerate(self.slots):
            if s is not None and s.cancel_requested:
                self._finalize(i, s, FINISH_CANCELLED)

    def _expire_deadlines(self) -> None:
        """Finish in-flight sessions whose wall-clock deadline passed (their
        partial output stays on the handle)."""
        now = time.perf_counter()
        for i, s in enumerate(self.slots):
            if s is not None and s.deadline_expired(now):
                self._finalize(i, s, FINISH_DEADLINE)

    def _quarantine_lane(self, lane: int, session: Session) -> None:
        """NaN-guard response: bench the lane, retry the session elsewhere.

        The poisoned tick's token is never recorded, so the retried session
        replays prompt+output through prefill and resumes token-exact.  The
        lane's pages return to the pool immediately, but the lane itself
        sits out ``quarantine_ticks``.
        """
        self._release_lane(lane)
        self._quarantined[lane] = self.tick + self.cfg.quarantine_ticks
        self.metrics.record_nan_event()
        self.metrics.record_quarantine()
        self.requeue(session)

    def _admit(self) -> list:
        """Claim free non-quarantined slots for scheduler-selected sessions.

        In paged mode admission is additionally page-aware: a selected
        session that does not fit in the pool right now is re-queued via
        ``scheduler.submit`` (such waits do not touch the retry budget).
        Selected sessions that were cancelled while queued finish as
        ``cancelled``, ones whose deadline already passed finish as
        ``deadline``, and ones still inside their requeue backoff window go
        back to the queue untouched.
        """
        free = [
            i for i, s in enumerate(self.slots)
            if s is None and self._quarantined.get(i, 0) <= self.tick
        ]
        if not free:
            return []
        picked = self.scheduler.select(len(free), self.cfg.n_slots)
        if len(picked) > len(free):
            raise RuntimeError(
                f"scheduler returned {len(picked)} sessions for {len(free)} free slots"
            )
        now = time.perf_counter()
        assignments = []
        for session in picked:
            if session.done:  # e.g. cancelled-in-queue under a custom policy
                continue
            if session.cancel_requested:
                session._finish(FINISH_CANCELLED)
                self._record_queued_cancel(session)
                continue
            if session.deadline_expired(now):
                session._finish(FINISH_DEADLINE, now=now)
                self.metrics.record_finished(session)
                self.finished.append(session)
                continue
            if session._backoff_until > self.tick:
                self.scheduler.submit(session)  # backoff: not eligible yet
                continue
            lane = free[0]
            if self.paged:
                plan = self._try_admit_paged(lane, session)
                if plan is None:  # pool full: wait without losing the request
                    self.scheduler.submit(session)
                    continue
            else:
                plan = (lane, session, session.prompt + session.out, 0)
            free.pop(0)
            session.status = PREFILL
            session.stats.admitted_at = now
            self.slots[lane] = session
            assignments.append(plan)
        return assignments

    # ------------------------------------------------------------------
    def _prefill(self, assignments: list) -> None:
        """Chunked batched prefill: every admitted prompt advances through
        the same ``decode_chunk`` call, ``prefill_chunk`` tokens per step.
        Lanes not being prefilled carry the pad position sentinel, which
        writes nothing — mid-generation neighbours are untouched.

        Each assignment is ``(lane, session, feed, start)``: ``feed`` is the
        token stream whose KV the lane must hold (prompt, plus prior output
        for preemption resumes) and ``start`` is the first position actually
        fed — positions below it come from shared prefix pages.
        """
        t0 = time.perf_counter()
        n_slots, chunk = self.cfg.n_slots, self.cfg.prefill_chunk
        spans = {lane: len(feed) - start for lane, _, feed, start in assignments}
        longest = max(spans.values())
        n_chunks = -(-longest // chunk)
        toks = np.zeros((n_slots, n_chunks * chunk), np.int32)
        poss = np.full((n_slots, n_chunks * chunk), self._pad_pos, np.int32)
        for lane, _, feed, start in assignments:
            n = len(feed) - start
            toks[lane, :n] = feed[start:]
            poss[lane, :n] = np.arange(start, len(feed), dtype=np.int32)
        bt_args = (self._device_ints(self._bt),) if self.paged else ()
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            logits, self.cache = self._call_compiled(
                "chunk", self.params, self.cache, *bt_args,
                self._device_ints(toks[:, sl]), self._device_ints(poss[:, sl]),
            )
            ending = [
                (lane, s, feed) for lane, s, feed, start in assignments
                if c * chunk < len(feed) - start <= (c + 1) * chunk
            ]
            for lane, s, feed in ending:
                row = logits[lane, spans[lane] - 1 - c * chunk]
                if self.cfg.nan_guard and not bool(torch.isfinite(row).all()):
                    if self._nan_attr_tick != self.tick:
                        self._nan_attr_tick = self.tick
                        self._guard_attribute(
                            RuntimeError(f"non-finite prefill logits on lane {lane}")
                        )
                    self._quarantine_lane(lane, s)  # retry the session whole
                    continue
                tok = int(self.cfg.sampler(row))
                s.status = ACTIVE
                last = self.last_token.clone()
                last[lane] = tok
                self.last_token = last
                self._set_pos(lane, len(feed))
                self._lane_pos[lane] = len(feed)
                s._record_token(tok)  # TTFT stamps here (first admission only)
                reason = self._finish_reason(lane, s, tok)
                if reason:
                    self._finalize(lane, s, reason)
        self.metrics.record_prefill(
            (time.perf_counter() - t0) * self.step_time_scale,
            sum(spans.values()), len(assignments),
        )

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine tick: release cancellations, expire deadlines, admit +
        prefill, grow pages (preempting if the pool is dry), decode.

        Raises :class:`ReplicaCrashed` — before any state mutates — while
        the ``crashed`` fault flag is set.  Recorded step times are scaled
        by ``step_time_scale`` (the straggler-fault surface).
        """
        if self.crashed:
            raise ReplicaCrashed(
                f"engine is crashed (fault-injected); tick {self.tick}"
            )
        t_step0 = time.perf_counter()
        self.tick += 1
        if self._op_quarantine:  # quarantined kernel ops due for a re-probe
            self._heal_ops()
        if self._quarantined:  # lanes whose bench time has elapsed come back
            self._quarantined = {
                lane: t for lane, t in self._quarantined.items() if t > self.tick
            }
        self._release_cancelled()
        self._expire_deadlines()
        admitted = self._admit()
        if admitted:
            self._prefill(admitted)
        if self.paged:
            for lane in range(self.cfg.n_slots):
                if self.slots[lane] is not None:
                    self._grow_lane(lane)
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            self.last_step_s = (time.perf_counter() - t_step0) * self.step_time_scale
            self.last_step_recompiled, self._recompiled = self._recompiled, False
            return
        t0 = time.perf_counter()
        bt_args = (self._device_ints(self._bt),) if self.paged else ()
        logits, self.cache = self._call_compiled(
            "decode", self.params, self.cache, *bt_args, self.last_token, self.pos
        )
        if self._inject_nan_lanes:  # fault surface: poison the real logits
            logits = logits.clone()
            for lane in sorted(self._inject_nan_lanes):
                if 0 <= lane < self.cfg.n_slots:
                    logits[lane] = float("nan")
        bad = []
        if self.cfg.nan_guard:
            finite = torch.isfinite(logits).all(dim=-1).cpu()
            bad = [i for i in active if not bool(finite[i])]
        if bad and self._nan_attr_tick != self.tick:
            # a kernel op emitting non-finite values shows up in its probe:
            # quarantine it per-op (the lanes still retry below either way)
            self._nan_attr_tick = self.tick
            self._guard_attribute(
                RuntimeError(f"non-finite decode logits on lane(s) {bad}")
            )
        next_tok = self.cfg.sampler(logits)
        toks = next_tok.cpu().numpy()  # waits for the step
        t_decode = time.perf_counter() - t0
        for i in bad:  # quarantine before pos advances: the lane pads out
            self._quarantine_lane(i, self.slots[i])
        ok = [i for i in active if i not in bad]
        self.last_token = next_tok.to(torch.int32)
        # pad lanes must stay at the sentinel (a pad-lane write would land in
        # pool pages someone else owns); surviving active lanes advance by one
        if self.paged:
            adv = np.zeros((self.cfg.n_slots,), np.int32)
            adv[ok] = 1
            self.pos = self.pos + self._device_ints(adv)
        else:
            self.pos = self.pos + 1
        for i in ok:
            s = self.slots[i]
            self._lane_pos[i] += 1
            s._record_token(int(toks[i]))
            reason = self._finish_reason(i, s, int(toks[i]))
            if reason:
                self._finalize(i, s, reason)
        scale = self.step_time_scale
        self.metrics.record_tick(
            (time.perf_counter() - t0) * scale, t_decode * scale, len(active)
        )
        if self.paged:
            self.metrics.record_pages(self.allocator.used)
        self.last_step_s = (time.perf_counter() - t_step0) * scale
        self.last_step_recompiled, self._recompiled = self._recompiled, False

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return any(s is not None for s in self.slots) or self.scheduler.pending() > 0

    def run(self, max_ticks: int = 10_000) -> list:
        """Drive until drained (or ``max_ticks``); returns finished sessions
        (cancelled ones included, ``finish_reason == "cancelled"``).

        Exhausting the tick budget with work still pending is surfaced — a
        ``RuntimeWarning`` plus the ``tick_budget_exhausted`` metrics counter
        — instead of returning silently with sessions stranded in flight.
        """
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
        if self.has_work():
            self.metrics.record_tick_budget_exhausted()
            warnings.warn(
                f"run(max_ticks={max_ticks}) stopped with work still pending "
                f"({sum(s is not None for s in self.slots)} active lane(s), "
                f"{self.scheduler.pending()} queued)",
                RuntimeWarning,
                stacklevel=2,
            )
        return self.finished

    def drain(self) -> list:
        """Evict every in-flight and queued session, with output intact.

        Slot lanes are released (paged lanes return their pages) and every
        live session — running or queued — comes back in ``QUEUED`` state.
        Only slot-drained sessions count a preemption.  Because a re-admitted
        session replays prompt+output through prefill, the returned sessions
        can be re-submitted to any engine over the same params and resume
        token-exact.
        """
        drained = []
        for lane, session in enumerate(self.slots):
            if session is not None:
                self._release_lane(lane)
                session.status = QUEUED
                session.stats.preemptions += 1  # evicted mid-flight, will resume
                drained.append(session)
        # Empty the queue via the scheduler's optional drain() extension;
        # otherwise pull through select with n_free clamped up to n_slots so
        # batch-boundary policies release too, stopping when select comes
        # back empty (a withholding scheduler strands its queue, but drain()
        # itself terminates).
        drainer = getattr(self.scheduler, "drain", None)
        if drainer is not None:
            queued = list(drainer())
        else:
            queued = []
            while self.scheduler.pending() > 0:
                batch = self.scheduler.select(
                    max(self.scheduler.pending(), self.cfg.n_slots), self.cfg.n_slots
                )
                if not batch:
                    break
                queued.extend(batch)
        for session in queued:
            session.status = QUEUED  # no lane lost: not a preemption
            drained.append(session)
        return drained

    def summary(self) -> dict:
        return self.metrics.summary()

    def reset_metrics(self) -> None:
        """Discard accumulated telemetry and the finished list (keeps the
        steps bound) — call after a warm-up pass so one-time costs stay out
        of the measured TTFT/latency records."""
        self.metrics = EngineMetrics(self.cfg.n_slots, n_pages=self.n_pages)
        self.finished = []
        self._guard_calls = 0
        self._injected_drift_calls = 0
