"""Program registry: every hot device program captured once per bucket.

The port's counterpart of ``headlamp_tpu/models/aot.py``. JAX lowers and
compiles each hot program at ``serve()`` startup, once per canonical
bucket shape, so no request pays a compile. On the card the counterpart
is a CUDA graph: at startup a background thread captures each program
(the fleet and region rollups, the cold and warm bucketed fits, the fused
rollup+forecast) once at its bucket shape with static input and output
buffers, and requests replay it. A replay launches the whole program
(about 130 kernels per Adam step for a fit) with one host call. Each
capture is tracked in the graph cost ledger (``obs/graphcost.py``) with
``phase="startup"`` under the exact ``(program, signature)`` that the
request path replays, so ``request_captures()`` stays 0 once the
registry is ready.

Shape policy, as in JAX: chip counts pad up to :data:`CHIP_BUCKETS`
with a weight per chip so padding never reaches the fit
(``forecast.pad_series_to_bucket``), and rollup columns come at the
encoder's power-of-two node and pod buckets (:data:`ROLLUP_BUCKETS`;
``ensure_rollup_shapes`` backfills the buckets a live fleet encodes to).
A shape no bucket covers is a counted miss, never an error: the caller
runs the same program eagerly, counted in the ledger.

Scope: one registry per process, as in JAX (:func:`registry`,
:func:`set_registry`). A graph belongs to the device it was captured
on, so the registry's key carries the device: ``(name, key, device)``.
A graph holds no context's data between calls. The port's fleet columns
belong to each data context, so every replay copies the calling
context's columns (device to device) and carry into the graph's static
inputs, and holds the graph's lock until what outlives the call is safe:
the carry cloned out of the graph's pool, the predictions, MSE and
rollup fetched to the host.

Captures on the card (:class:`GraphProgram`): the program is warmed up
eagerly on a side stream first (the kernel's library is built and its
launch configuration set, cuBLAS and autograd allocate), then captured
in ``thread_local`` mode on that non-blocking stream, so request threads
launching work and copying to the host on the same card meanwhile
neither invalidate the capture nor make it raise. On the CPU a builder
returns the same program as an eager callable (:class:`EagerProgram`),
so the CPU tests drive the lookups, buckets and counters.

Deliberate differences from JAX: a failed capture is recorded in
``compile_errors`` and ``last_error`` and turns the host's ``/healthz``
``ok`` false (JAX records it and lets requests miss); a replay that
raises is counted in ``exec_failures`` and propagates (JAX quietly
re-runs the plain program).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Sequence

import torch

from ..device import DeviceLike, resolve_device
from ..obs import graphcost
from ..obs.metrics import registry as _metrics_registry
from .forecast import (
    COLD_PROGRAM,
    PARAM_NAMES,
    WARM_PROGRAM,
    WARM_STEPS,
    ForecastConfig,
    _bucketed_fit_forecast_state_program,
    _bucketed_warm_fit_forecast_program,
    _rollup_forecast_body,
    adam_init,
    carry_from_tensors,
    carry_tensors,
    init_params,
)

#: Chip-axis buckets the forecast programs are captured at: 8 for the SLO
#: burn self-forecast (1 series) and toy fleets, 64 for the demo fleet,
#: 256 for larger scrapes. Above the top bucket a fit runs eagerly.
CHIP_BUCKETS: tuple[int, ...] = (8, 64, 256)

#: (node_pad, pod_pad) column buckets of the fleet and region rollups:
#: the encoder's power-of-two padding of the 256-node bench fleet, the
#: 1024-node large fixture and the 4k/16k viewport fixtures. The TPU
#: view's pods pad to the same power of two as its nodes at every
#: fixture size, hence the square pairs.
ROLLUP_BUCKETS: tuple[tuple[int, int], ...] = (
    (256, 256),
    (1024, 1024),
    (4096, 4096),
    (16384, 16384),
)

#: Buckets of the fused rollup+forecast: only the pre-viewport sizes, as
#: in JAX. A 4k+ fleet on the fused path is a miss and takes the split
#: path, whose rollup and fit are both captured.
FUSED_BUCKETS: tuple[tuple[int, int], ...] = ROLLUP_BUCKETS[:2]

#: Fleet sizes ``bench_viewport`` paints. The startup pass checks that
#: the bucket table covers each (:func:`viewport_bucket_gaps`).
VIEWPORT_FLEET_SIZES: tuple[int, ...] = (1024, 4096, 16384)

#: History length of the live-window range query (3600 s at 60 s): THE
#: page forecast's series length.
LIVE_WINDOW_SAMPLES = 61

#: Steady-state length of the SLO burn self-forecast's series.
SLO_SERIES_STEADY = 512

#: Registry names of the rollups and the fused program (JAX's names).
FLEET_ROLLUP = "analytics.fleet_rollup"
REGION_ROLLUP = "analytics.region_rollup"
FUSED_PROGRAM = "fused.rollup_and_forecast"

#: Eager runs of a program before its capture: the kernel's launch
#: configuration, cuBLAS's workspace and autograd's buffers must all
#: exist before the capture begins.
WARMUP_RUNS = 3


def _canonical(device: DeviceLike) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card, so a
    lookup from a tensor on ``cuda:0`` finds what was captured for
    ``cuda``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def chip_bucket_for(n_chips: int) -> int | None:
    """Smallest chip bucket holding ``n_chips``, or None above the top."""
    for bucket in CHIP_BUCKETS:
        if n_chips <= bucket:
            return bucket
    return None


def _pow2_bucket(n: int, minimum: int = 8) -> int:
    """Twin of the encoder's ``_bucket`` (power-of-two pad with a floor),
    pinned equal to it by test."""
    size = minimum
    while size < n:
        size *= 2
    return size


def default_specs() -> list[tuple[str, Any]]:
    """The startup set, JAX's without its mesh rollup (the port has
    no mesh yet): both rollups at every rollup bucket, the cold and warm
    fits at the page's (64, 61) and the SLO forecast's (8, 512), the
    fused program at the fused buckets. A forecast key is ``(bucket,
    length, cfg, steps)``: JAX's key without its inference path and
    Pallas batch, since the port has one inference path per device."""
    cfg = ForecastConfig()
    specs: list[tuple[str, Any]] = []
    for node, pod in ROLLUP_BUCKETS:
        specs.append((FLEET_ROLLUP, ((node,), (pod,))))
        specs.append((REGION_ROLLUP, ((node,), (pod,))))
    for bucket, length in ((64, LIVE_WINDOW_SAMPLES), (8, SLO_SERIES_STEADY)):
        specs.append((COLD_PROGRAM, (bucket, length, cfg, 60)))
        specs.append((WARM_PROGRAM, (bucket, length, cfg, WARM_STEPS)))
    for node, pod in FUSED_BUCKETS:
        specs.append(
            (FUSED_PROGRAM, ((node,), (pod,), 64, LIVE_WINDOW_SAMPLES, cfg, WARM_STEPS))
        )
    return specs


def viewport_bucket_gaps(
    specs: list[tuple[str, Any]] | None = None,
    fleet_sizes: tuple[int, ...] = VIEWPORT_FLEET_SIZES,
) -> list[tuple[str, tuple[int, int]]]:
    """Every (program, (node_pad, pod_pad)) a ``bench_viewport`` fleet
    size needs and ``specs`` does not capture. The startup pass records
    a non-empty result as a capture error; a test holds it empty."""
    if specs is None:
        specs = default_specs()
    have = {(name, key) for name, key in specs}
    gaps: list[tuple[str, tuple[int, int]]] = []
    for n in fleet_sizes:
        pad = _pow2_bucket(n)
        for program in (FLEET_ROLLUP, REGION_ROLLUP):
            if (program, ((pad,), (pad,))) not in have:
                gaps.append((program, (pad, pad)))
    return gaps


# ---------------------------------------------------------------------------
# Programs: a captured graph on the card, an eager callable on the CPU
# ---------------------------------------------------------------------------

Outputs = tuple[torch.Tensor, ...]


class EagerProgram:
    """A program on the CPU: the same torch ops, run when called. The
    inputs are used as they are; nothing is shared between calls."""

    kernel_launches = 0

    def __init__(self, fn: Callable[..., Outputs], device: torch.device) -> None:
        self._fn = fn
        self.device = device

    def run(self, inputs: Sequence[torch.Tensor], finish: Callable[[Outputs], Any]) -> Any:
        return finish(self._fn(*inputs))


class GraphProgram:
    """A program captured as one CUDA graph at its bucket shape, with
    the static input buffers it reads and the output buffers it writes.

    ``kernel_launches`` is how many times the capture called the
    forecast kernel's wrapper: a replay launches the kernel that many
    times and adds them to ``fused_forward.LAUNCHES`` itself. Warm-up
    and capture count for no path."""

    def __init__(self, fn: Callable[..., Outputs], inputs: list[torch.Tensor]) -> None:
        from .fused_forward import LAUNCHES

        self.device = inputs[0].device
        self._inputs = inputs
        self._lock = threading.Lock()
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), LAUNCHES.tally():
            # A side stream from the pool is non-blocking: it never waits
            # on the legacy default stream that request threads use.
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_RUNS):
                    fn(*inputs)
            stream.synchronize()
            with LAUNCHES.tally() as tally:
                with torch.cuda.graph(
                    self._graph, stream=stream, capture_error_mode="thread_local"
                ):
                    self._outputs = fn(*inputs)
        self.kernel_launches = tally[0]

    def run(self, inputs: Sequence[torch.Tensor], finish: Callable[[Outputs], Any]) -> Any:
        """Copy ``inputs`` into the static inputs, replay on the calling
        thread's stream and return ``finish(outputs)``, all under the
        graph's lock: ``finish`` must clone or fetch whatever outlives
        the call, since the next replay rewrites the outputs."""
        from .fused_forward import LAUNCHES

        with self._lock:
            for static, value in zip(self._inputs, inputs, strict=True):
                static.copy_(value)
            self._graph.replay()
            LAUNCHES.add(self.kernel_launches)
            return finish(self._outputs)


#: What a builder returns and a lookup finds.
Program = EagerProgram | GraphProgram


def _program(fn: Callable[..., Outputs], inputs: list[torch.Tensor]) -> Program:
    device = inputs[0].device
    if device.type == "cuda":
        return GraphProgram(fn, inputs)
    return EagerProgram(fn, device)


def _columns(shape: Any, n: int, device: torch.device) -> list[torch.Tensor]:
    return [torch.zeros(tuple(shape), dtype=torch.int32, device=device) for _ in range(n)]


def _fleet_rollup_program(*cols: torch.Tensor) -> Outputs:
    from ..analytics.fleet_torch import fleet_rollup, pack_rollup

    return (pack_rollup(fleet_rollup(*cols)),)


def _region_rollup_program(*cols: torch.Tensor) -> Outputs:
    from ..analytics.fleet_torch import pack_region_rollup, region_rollup

    return (pack_region_rollup(region_rollup(*cols)),)


def _build_fleet_rollup(key: Any, device: torch.device) -> Program:
    node_shape, pod_shape = key
    inputs = _columns(node_shape, 5, device) + _columns(pod_shape, 4, device)
    return _program(_fleet_rollup_program, inputs)


def _build_region_rollup(key: Any, device: torch.device) -> Program:
    node_shape, pod_shape = key
    inputs = _columns(node_shape, 6, device) + _columns(pod_shape, 4, device)
    return _program(_region_rollup_program, inputs)


def _fit_inputs(bucket: int, length: int, cfg: ForecastConfig, device: torch.device,
                warm: bool) -> list[torch.Tensor]:
    """Static inputs of a bucketed fit: series, chip weights and the
    carry (init params alone for the cold program), filled with a seeded
    init so the warm-up trains on finite values."""
    params = init_params(torch.Generator().manual_seed(0), cfg, device=device)
    series = torch.zeros((bucket, length), dtype=torch.float32, device=device)
    weights = torch.ones((bucket,), dtype=torch.float32, device=device)
    carry = carry_tensors(params, adam_init(params) if warm else None)
    return [series, weights, *carry]


def _build_forecast(name: str, key: Any, device: torch.device) -> Program:
    bucket, length, cfg, steps = key
    if name == COLD_PROGRAM:
        def fn(series: torch.Tensor, weights: torch.Tensor, *init: torch.Tensor) -> Outputs:
            out, params, opt_state, mse = _bucketed_fit_forecast_state_program(
                series, weights, dict(zip(PARAM_NAMES, init)), cfg, steps
            )
            return (out, *carry_tensors(params, opt_state), mse)
    else:
        def fn(series: torch.Tensor, weights: torch.Tensor, *carry: torch.Tensor) -> Outputs:
            out, params, opt_state, mse = _bucketed_warm_fit_forecast_program(
                series, weights, *carry_from_tensors(carry), cfg, steps
            )
            return (out, *carry_tensors(params, opt_state), mse)
    _build_kernel(device)
    return _program(fn, _fit_inputs(bucket, length, cfg, device, warm=name == WARM_PROGRAM))


def _build_fused(key: Any, device: torch.device) -> Program:
    node_shape, pod_shape, bucket, length, cfg, steps = key

    def fn(*inputs: torch.Tensor) -> Outputs:
        cols, series, weights, carry = inputs[:9], inputs[9], inputs[10], inputs[11:]
        packed, out, params, opt_state, mse = _rollup_forecast_body(
            *cols, series, weights, *carry_from_tensors(carry), cfg, steps
        )
        return (packed, out, *carry_tensors(params, opt_state), mse)

    cols = _columns(node_shape, 5, device) + _columns(pod_shape, 4, device)
    _build_kernel(device)
    return _program(fn, cols + _fit_inputs(bucket, length, cfg, device, warm=True))


def _build_kernel(device: torch.device) -> None:
    """Build (or load) the forecast kernel's library before a capture
    that holds the kernel: nvcc runs once, outside every capture."""
    if device.type == "cuda":
        from .fused_forward import _library

        _library()


_BUILDERS: dict[str, Callable[[Any, torch.device], Program]] = {
    FLEET_ROLLUP: _build_fleet_rollup,
    REGION_ROLLUP: _build_region_rollup,
    COLD_PROGRAM: lambda key, device: _build_forecast(COLD_PROGRAM, key, device),
    WARM_PROGRAM: lambda key, device: _build_forecast(WARM_PROGRAM, key, device),
    FUSED_PROGRAM: _build_fused,
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class AotProgramRegistry:
    """Captured programs keyed ``(name, key, device)``. The ledger
    signature of a program is ``(key, device)``, so the startup capture
    and every later replay land on the same ledger row.

    States: ``idle`` (never started: every lookup is a no-op),
    ``compiling`` (the startup pass is capturing), ``ready``,
    ``unavailable`` (the startup set could not be built). Thread-safety:
    the lock guards the program dict and the counters; captures happen
    outside it, one at a time (``_capture_lock``). ``perf`` is the
    injectable duration seam; ``specs`` overrides the startup set."""

    def __init__(
        self,
        *,
        specs: list[tuple[str, Any]] | None = None,
        perf: Callable[[], float] = time.perf_counter,
    ) -> None:
        self._lock = threading.Lock()
        self._capture_lock = threading.Lock()
        self._perf = perf
        self._specs = specs
        self._programs: dict[tuple[str, Any, str], Program] = {}
        self._pending: set[tuple[str, Any, str]] = set()
        self._state = "idle"  # idle | compiling | ready | unavailable
        self._ready_event = threading.Event()
        self._threads: list[threading.Thread] = []
        self.device: torch.device | None = None
        self.last_error: str | None = None
        self.programs_compiled = 0
        self.compile_errors = 0
        self.exec_failures = 0
        self.bucket_hits = 0
        self.bucket_misses = 0
        #: Carry bytes that warm replays wrote into a graph's reused
        #: static inputs: the buffers JAX's donation lets XLA reuse.
        self.donation_saved_bytes = 0
        self.compile_ms_total = 0.0

    # -- startup ---------------------------------------------------------

    def compile_startup(self, device: DeviceLike = None, *, block: bool = False) -> None:
        """Start (or, idempotently, skip) the startup capture pass on
        ``device``. ``block=True`` runs it inline (tests); ``serve()``
        uses the background thread, so listening starts at once and early
        requests run eagerly."""
        dev = _canonical(device)
        with self._lock:
            if self._state != "idle":
                return
            self._state = "compiling"
            self.device = dev
        if block:
            self._compile_all(dev)
            return
        self._spawn(self._compile_all, (dev,), "hl-torch-aot-capture")

    def _spawn(self, target: Callable[..., None], args: tuple, name: str) -> None:
        thread = threading.Thread(target=target, args=args, name=name, daemon=True)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()] + [thread]
        thread.start()

    def _compile_all(self, device: torch.device) -> None:
        try:
            specs = self._specs if self._specs is not None else default_specs()
        except Exception as exc:  # noqa: BLE001 — recorded; every lookup then misses
            self._record_error(f"{type(exc).__name__}: {exc}")
            with self._lock:
                self._state = "unavailable"
            self._ready_event.set()
            return
        if self._specs is None:
            gaps = viewport_bucket_gaps(specs)
            if gaps:
                self._record_error(f"viewport buckets uncovered: {gaps}")
        for name, key in specs:
            self._compile_one(name, key, device)
        with self._lock:
            self._state = "ready"
        self._ready_event.set()

    def _record_error(self, message: str) -> None:
        with self._lock:
            self.compile_errors += 1
            self.last_error = message[:200]

    def _compile_one(self, name: str, key: Any, device: torch.device) -> None:
        """Capture one program on ``device``, ledger-tracked as a
        startup-phase capture under the signature the request path
        replays. A failed capture is recorded, never raised: its lookups
        miss and run eagerly, and the host's /healthz reads the error."""
        builder = _BUILDERS.get(name)
        if builder is None:
            self._record_error(f"no builder for {name!r}")
            return
        on_card = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        t0 = self._perf()
        try:
            with self._capture_lock, on_card:
                with graphcost.track(name, (key, str(device)), phase="startup"):
                    program = builder(key, device)
        except Exception as exc:  # noqa: BLE001 — recorded; the host reports it
            self._record_error(f"{name}: {type(exc).__name__}: {exc}")
            return
        elapsed_ms = (self._perf() - t0) * 1000.0
        with self._lock:
            self._programs[(name, key, str(device))] = program
            self.programs_compiled += 1
            self.compile_ms_total += elapsed_ms

    # -- request-side lookups --------------------------------------------

    def ready(self) -> bool:
        return self._state == "ready"

    @property
    def state(self) -> str:
        return self._state

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Block until the startup pass finished (either outcome)."""
        return self._ready_event.wait(timeout)

    def join(self, timeout: float | None = None) -> bool:
        """Join the startup and backfill threads; True when none is left."""
        with self._lock:
            threads = list(self._threads)
        for thread in threads:
            thread.join(timeout)
        return not any(t.is_alive() for t in threads)

    def executable(self, name: str, key: Any, device: torch.device) -> Program | None:
        """The program captured for exactly ``(name, key)`` on ``device``,
        or None (a counted bucket miss). Callers gate on :meth:`ready`."""
        pair = (name, key, str(_canonical(device)))
        with self._lock:
            program = self._programs.get(pair)
            if program is None:
                self.bucket_misses += 1
            else:
                self.bucket_hits += 1
        return program

    def lookup(self, name: str, key: Any, device: torch.device) -> Program | None:
        """:meth:`executable` once the registry is ready; None (and no
        count) before."""
        return self.executable(name, key, device) if self.ready() else None

    def replay(
        self,
        name: str,
        key: Any,
        program: Program,
        inputs: Sequence[torch.Tensor],
        finish: Callable[[Outputs], Any],
        *,
        donated: int = 0,
    ) -> Any:
        """Run ``program`` on ``inputs`` and return ``finish(outputs)``
        (see :meth:`GraphProgram.run`), tracked in the ledger. A replay
        that raises is counted and propagates."""
        try:
            with graphcost.track(name, (key, str(program.device))):
                result = program.run(inputs, finish)
        except Exception as exc:
            self.note_exec_failure(name, f"{type(exc).__name__}: {exc}")
            raise
        if donated:
            self.note_donation(donated)
        return result

    def note_bucket_miss(self, name: str) -> None:  # noqa: ARG002 — JAX's signature
        """A shape no bucket can hold, counted without a dict lookup."""
        with self._lock:
            self.bucket_misses += 1

    def note_donation(self, n_bytes: int) -> None:
        with self._lock:
            self.donation_saved_bytes += int(n_bytes)

    def note_exec_failure(self, name: str, reason: str) -> None:
        with self._lock:
            self.exec_failures += 1
            self.last_error = f"{name}: {reason}"[:200]

    # -- background backfill ---------------------------------------------

    def ensure(self, name: str, key: Any, device: DeviceLike = None) -> bool:
        """Capture ``(name, key)`` on ``device`` on a background thread
        unless it is captured or in flight. Returns True when a capture
        was scheduled. Serving never waits on it."""
        dev = _canonical(device)
        pair = (name, key, str(dev))
        with self._lock:
            if self._state in ("idle", "unavailable"):
                return False
            if pair in self._programs or pair in self._pending:
                return False
            self._pending.add(pair)

        def run() -> None:
            try:
                self._compile_one(name, key, dev)
            finally:
                with self._lock:
                    self._pending.discard(pair)

        self._spawn(run, (), "hl-torch-aot-backfill")
        return True

    def ensure_rollup_shapes(self, node_pad: int, pod_pad: int, device: DeviceLike = None) -> None:
        """Backfill both rollups at the (node, pod) buckets a live fleet
        actually encodes to, from the device-cache warm."""
        self.ensure(FLEET_ROLLUP, ((node_pad,), (pod_pad,)), device)
        self.ensure(REGION_ROLLUP, ((node_pad,), (pod_pad,)), device)

    # -- read surfaces ---------------------------------------------------

    def counters(self) -> dict[str, int]:
        """Monotone ints, lock-free."""
        return {
            "programs_compiled": self.programs_compiled,
            "compile_errors": self.compile_errors,
            "exec_failures": self.exec_failures,
            "bucket_hits": self.bucket_hits,
            "bucket_misses": self.bucket_misses,
            "donation_saved_bytes": self.donation_saved_bytes,
        }

    def snapshot(self) -> dict[str, Any]:
        """The ``/healthz`` ``runtime.aot`` block."""
        with self._lock:
            programs = sorted(name for name, _key, _dev in self._programs)
        return {
            "state": self._state,
            "device": None if self.device is None else str(self.device),
            **self.counters(),
            "compile_ms_total": round(self.compile_ms_total, 1),
            "last_error": self.last_error,
            "programs": programs,
        }


#: The process registry; set_registry swaps it for tests and call sites
#: read through the accessor.
_REGISTRY = AotProgramRegistry()


def registry() -> AotProgramRegistry:
    return _REGISTRY


def set_registry(instance: AotProgramRegistry) -> AotProgramRegistry:
    """Install ``instance`` as the process registry; returns the one it
    replaced so tests can restore."""
    global _REGISTRY
    previous, _REGISTRY = _REGISTRY, instance
    return previous


_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_aot_programs_compiled_count",
    "Programs the registry holds captured (startup specs and backfills)",
    lambda: float(registry().programs_compiled),
)
_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_aot_compile_errors_total",
    "Captures that failed (they turn /healthz ok false)",
    lambda: float(registry().compile_errors),
)
_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_aot_bucket_hits_total",
    "Request-path lookups served by a captured program",
    lambda: float(registry().bucket_hits),
)
_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_aot_bucket_misses_total",
    "Request-path lookups no bucket covered (the eager program ran)",
    lambda: float(registry().bucket_misses),
)
_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_aot_donation_saved_bytes_total",
    "Carry bytes warm replays wrote into reused static graph inputs",
    lambda: float(registry().donation_saved_bytes),
)
