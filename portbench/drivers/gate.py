"""The gate cells: the port's shipped health gate, run back to back.

``IciHealthGate.tpu_defaults()`` is the battery the validation hook, the
probe pod's payload and the full-tier monitor run. A closed loop of one
caller runs it over one warm gate; each battery's seconds are one sample.

The port's probes fix their own inputs. Without editing the port, the
benchmark puts inputs made from the run's seed in their place and takes
their outputs as they are produced (``GateProbes``). It relies on these
names of the port, and says which one failed where a battery ran without
going through it (``HookError``):

* ``ops.matmul._PROBE_CACHE`` and ``_ProbeEntry``: the matmul probe's
  cached entry is replaced by one of seeded operands, made the way the
  probe makes its own. ``ops.matmul.matmul``, wrapped, hands over the
  checked product (on the seeded A) and each link of the chain (on the
  seeded B / sqrt(n)); a link made while a CUDA graph is captured is the
  graph's output, which every replay rewrites, so after each battery it
  holds that battery's chain result (it is filled with NaN before);
* ``ops.flash_attention.host_qkv`` is replaced by the seeded q, k and v,
  drawn anew at each call as the probe draws its own, and
  ``ops.flash_attention.flash_attention``, wrapped, hands over the output
  of every call;
* the gate's world's ``run``: ``World.run(sharded_losses, axes, cfg)`` is
  given seeded parameters and tokens through the function's own
  ``params`` and ``tokens`` arguments, and its losses are read;
* ``tpu.health``'s ``run_ici_probes``, ``mxu_probe`` and
  ``flash_attention_probe`` and the gate's ``_burnin``: spans wrap them
  (closed after the card has finished, with tracing on).
"""

from __future__ import annotations

import math
import random
import statistics
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import checks, devtrace, roofline
from ..record import Run
from ..reference import attention as ref_attention
from ..reference import burnin as ref_burnin
from ..reference import inputs
from ..reference import matmul as ref_matmul


class _Tap:
    """A stand-in for a function of the port that hands each call's
    arguments and result to ``seen``. Attributes are the function's own:
    the port counts its launches on the function object."""

    def __init__(self, fn, seen) -> None:
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_seen", seen)

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        self._seen(args, out)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value) -> None:
        setattr(self._fn, name, value)


class HookError(RuntimeError):
    """A battery ran without going through a name of the port that the
    benchmark relies on (module doc): a change to the port moved it."""


@dataclass
class Battery:
    """What one battery produced: its verdict, seconds and outputs."""

    ok: bool = False
    seconds: float = 0.0
    #: The matmul probe's checked product, and its chain's last link.
    k1: object = None
    chain: object = None
    #: The output of every flash_attention call of the flash probe.
    k2: list = field(default_factory=list)
    losses: Optional[list] = None
    #: Calls of the seeded host_qkv.
    qkv_calls: int = 0


class GateProbes:
    """Seeded inputs into one gate's probes and their outputs out, and the
    comparison of those outputs with the reference (module doc)."""

    def __init__(self, gate, gate_conf: dict, seed: int, run: Run, sample: int) -> None:
        self.gate = gate
        self.conf = gate_conf
        self.seed = seed
        self.run = run
        self.sample = sample
        self._rng = random.Random(inputs.stream(seed, "sample"))
        self._originals: list = []
        self.current: Optional[Battery] = None
        #: Every battery of the window, and the kept outputs' indexes.
        self.batteries: list[Battery] = []
        self._kept: list[int] = []
        self._burnin_inputs: dict = {}
        #: The burn-in's batch, once a battery has run it.
        self.burnin_batch: Optional[int] = None
        #: The seeded operands on the probe's device, and the device.
        self.a_lp = self.b_scaled = None
        self.device = "cpu"
        #: The chain's last link as captured in a CUDA graph (each replay
        #: rewrites it), and the links the capture held.
        self.chain_out = None
        self.chain_links = 0

    # -- wiring ------------------------------------------------------------
    def _swap(self, owner, name: str, value) -> None:
        if not hasattr(owner, name):
            owner_name = getattr(owner, "__name__", type(owner).__name__)
            raise HookError(f"the port has no {owner_name}.{name}, which the benchmark wraps")
        self._originals.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def install(self) -> None:
        """Wire the seeded inputs and the taps into the gate, whose world
        has formed (one battery has run)."""
        import torch

        from k8s_operator_libs_tpu_torch.models import burnin as port_burnin
        from k8s_operator_libs_tpu_torch.ops import flash_attention as port_flash
        from k8s_operator_libs_tpu_torch.ops import matmul as port_matmul
        from k8s_operator_libs_tpu_torch.tpu import health as port_health

        size = self.conf["matmul_size"]
        cache = getattr(port_matmul, "_PROBE_CACHE", None)
        entry_type = getattr(port_matmul, "_ProbeEntry", None)
        if cache is None or entry_type is None:
            raise HookError("ops.matmul._PROBE_CACHE or _ProbeEntry is gone: the benchmark "
                            "puts the matmul probe's seeded operands there")
        keys = [k for k in cache if k[0] == size]
        if len(keys) != 1:
            raise HookError(f"ops.matmul._PROBE_CACHE holds {len(keys)} entries of size {size}, "
                            "not the one the probe made")
        a, b = inputs.matmul_operands(self.seed, size)
        device = torch.device(keys[0][2])
        self.device = str(device)
        a_lp = torch.from_numpy(a).to(torch.bfloat16).to(device)
        b_lp = torch.from_numpy(b).to(torch.bfloat16).to(device)
        # The probe's own check reads a host product of its operands; the
        # probe's entry is made as the probe makes it.
        host = a_lp.float().cpu().numpy() @ b_lp.float().cpu().numpy()
        b_scaled = torch.from_numpy(b / np.sqrt(size)).to(torch.bfloat16).to(device)
        self.a_lp, self.b_scaled = a_lp, b_scaled
        cache[keys[0]] = entry_type((a_lp, b_lp, b_scaled, host))

        def seen_matmul(args, out) -> None:
            if len(args) < 2:
                return
            if args[1] is self.b_scaled:
                if out.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                    self.chain_out = out
                    self.chain_links += 1
                elif self.current is not None:
                    self.current.chain = out
            elif args[0] is self.a_lp and self.current is not None:
                if not (out.device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
                    self.current.k1 = out

        def seen_flash(args, out) -> None:
            if self.current is not None:
                self.current.k2.append(out)

        shape = tuple(self.conf["flash_shape"])

        def seeded_qkv(requested, seed):
            if tuple(requested) != shape:
                raise HookError(f"the flash probe asked host_qkv for {requested}, not {shape}")
            if self.current is not None:
                self.current.qkv_calls += 1
            return inputs.attention_operands(self.seed, shape)

        self._swap(port_matmul, "matmul", _Tap(port_matmul.matmul, seen_matmul))
        self._swap(port_flash, "flash_attention", _Tap(port_flash.flash_attention, seen_flash))
        self._swap(port_flash, "host_qkv", seeded_qkv)

        world = self.gate._world
        world_run = world.run
        burnin_conf = self.conf["burnin"]

        def run_with_seeded_burnin(fn, *args, **kwargs):
            if fn is not port_burnin.sharded_losses:
                return world_run(fn, *args, **kwargs)
            axes, cfg = args
            for key in ("vocab", "d_model", "n_heads", "d_ff", "n_layers", "seq_len"):
                if getattr(cfg, key) != burnin_conf[key]:
                    raise HookError(f"the burn-in's {key} is {getattr(cfg, key)}, "
                                    f"not {burnin_conf[key]}")
            self.burnin_batch = cfg.batch
            params, tokens = self.burnin_inputs(cfg.batch)
            results = world_run(fn, axes, cfg, burnin_conf["steps"], params, tokens, **kwargs)
            if self.current is not None:
                self.current.losses = list(results[0])
            return results

        self._swap(world, "run", run_with_seeded_burnin)
        sync = None
        if self.run.trace:
            cards = [d.index for d in world.devices if d.type == "cuda"]

            def sync() -> None:
                for index in cards:
                    torch.cuda.synchronize(index)

        for probe, name in (("collectives", "run_ici_probes"), ("mxu", "mxu_probe"),
                            ("flash", "flash_attention_probe")):
            self._swap(port_health, name, self._spanned(f"probe.{probe}",
                                                        getattr(port_health, name, None), sync))
        self._swap(self.gate, "_burnin",
                   self._spanned("probe.burnin", getattr(self.gate, "_burnin", None), sync))

    def _spanned(self, span: str, fn, sync):
        run = self.run

        def spanned(*args, **kwargs):
            with run.span(span, sync):
                return fn(*args, **kwargs)

        return spanned

    def uninstall(self) -> None:
        for owner, name, value in reversed(self._originals):
            setattr(owner, name, value)
        self._originals.clear()

    def burnin_inputs(self, batch: int) -> tuple:
        if batch not in self._burnin_inputs:
            c = self.conf["burnin"]
            self._burnin_inputs[batch] = (
                inputs.burnin_params(self.seed, c["vocab"], c["d_model"], c["d_ff"],
                                     c["n_layers"]),
                inputs.burnin_tokens(self.seed, c["vocab"], batch, c["seq_len"]),
            )
        return self._burnin_inputs[batch]

    def chain_links_expected(self) -> int:
        """The chain's links: the configuration's on a card, one on the CPU
        (where the port runs one plain link)."""
        return self.conf["mxu"]["chain"] if self.device.startswith("cuda") else 1

    # -- batteries ---------------------------------------------------------
    def battery(self, record: bool = True) -> Battery:
        """One ``gate.run()``; with ``record`` its outputs count."""
        self.current = Battery()
        if self.chain_out is not None:
            self.chain_out.fill_(math.nan)
        start = time.perf_counter()
        report = self.gate.run()
        current, self.current = self.current, None
        current.seconds = time.perf_counter() - start
        current.ok = report.ok
        if self.chain_out is not None:
            current.chain = self.chain_out.clone()
        self._check_hooks(report, current)
        if record:
            self._keep(current)
        return current

    def _check_hooks(self, report, battery: Battery) -> None:
        """A probe that passed without handing over what it checked went
        round the names the benchmark relies on."""
        if report.mxu is not None and report.mxu.ok:
            if battery.k1 is None:
                raise HookError("the matmul probe passed without a product of the seeded "
                                "operands: ops.matmul._PROBE_CACHE or ops.matmul.matmul "
                                "was bypassed")
            if battery.chain is None:
                raise HookError("the matmul probe passed without a chain on the seeded B: "
                                "ops.matmul._PROBE_CACHE or ops.matmul.matmul was bypassed")
            if self.chain_out is not None and self.chain_links != self.chain_links_expected():
                raise HookError(f"the captured chain held {self.chain_links} links of the "
                                f"seeded B, not {self.chain_links_expected()}")
        if report.flash is not None and report.flash.ok:
            if battery.qkv_calls == 0:
                raise HookError("the flash probe passed without calling "
                                "ops.flash_attention.host_qkv: the seeded q, k, v did not "
                                "reach it")
            if len(battery.k2) != self.conf["flash"]["calls"]:
                raise HookError(f"the flash probe made {len(battery.k2)} calls of "
                                "ops.flash_attention.flash_attention, not "
                                f"{self.conf['flash']['calls']}")
        if report.burnin_ok and battery.losses is None:
            raise HookError("the burn-in passed without World.run(sharded_losses, axes, cfg) "
                            "on the gate's world: the seeded parameters did not reach it")

    def _keep(self, battery: Battery) -> None:
        """Keep every battery's losses and verdict, and the outputs of a
        seeded sample (reservoir) and of the first and the last."""
        index = len(self.batteries)
        self.batteries.append(battery)
        if len(self._kept) < self.sample:
            self._kept.append(index)
        else:
            j = self._rng.randrange(index + 1)
            if j < self.sample:
                self._drop(self._kept[j])
                self._kept[j] = index
        if index >= 2 and index - 1 not in self._kept:
            self._drop(index - 1)  # the last but one is no longer the last

    def _drop(self, index: int) -> None:
        if index != 0 and index != len(self.batteries) - 1:
            battery = self.batteries[index]
            battery.k1 = battery.chain = None
            battery.k2 = []

    def kept(self) -> list[int]:
        last = len(self.batteries) - 1
        return sorted({0, last, *self._kept}) if self.batteries else []

    def host_outputs(self) -> None:
        """Move the kept outputs to the host (after the window)."""
        keep = set(self.kept())

        def host(t):
            return None if t is None else t.float().cpu().numpy()

        for i, battery in enumerate(self.batteries):
            if i in keep:
                battery.k1, battery.chain = host(battery.k1), host(battery.chain)
                battery.k2 = [host(t) for t in battery.k2]
            else:
                battery.k1 = battery.chain = None
                battery.k2 = []

    # -- the comparison ----------------------------------------------------
    def numbers(self) -> dict:
        """The numbers compared, over the kept outputs and every battery's
        losses (after ``host_outputs``)."""
        return gate_numbers(self.conf, self.seed, self.batteries, self.kept(),
                            self.burnin_batch, self.chain_links_expected(), self.device)


def gate_numbers(conf: dict, seed: int, batteries: list, kept: list,
                 burnin_batch: Optional[int], links: int, device: str = "cpu") -> dict:
    """Each gate number: the kept batteries' K1 outputs (the checked
    product and the chain of ``links`` links) and K2 outputs (every call)
    and every battery's losses against the reference of run ``seed``'s
    inputs, computed on ``device``, and the verdicts that were not ok."""
    a, b = inputs.matmul_operands(seed, conf["matmul_size"])
    k1_ref = ref_matmul.product(a, b)
    chain_ref = ref_matmul.chain(a, b, links, device)
    q, k, v = inputs.attention_operands(seed, tuple(conf["flash_shape"]))
    k2_ref = ref_attention.attention(q, k, v, causal=True)
    loss_err = drop_err = math.inf
    if burnin_batch is not None and batteries:
        c = conf["burnin"]
        params = inputs.burnin_params(seed, c["vocab"], c["d_model"], c["d_ff"], c["n_layers"])
        tokens = inputs.burnin_tokens(seed, c["vocab"], burnin_batch, c["seq_len"])
        losses_ref = ref_burnin.losses(params, tokens, c["n_heads"], steps=c["steps"], lr=c["lr"])
        errs = [checks.loss_errs(bt.losses, losses_ref) for bt in batteries]
        loss_err = max(loss for loss, _ in errs)
        drop_err = max(drop for _, drop in errs)
    chosen = [batteries[i] for i in kept]
    calls = conf["flash"]["calls"]

    def k2_err(bt) -> float:
        if len(bt.k2) != calls:
            return math.inf
        return max(checks.rel_err(out, k2_ref) for out in bt.k2)

    return {
        "k1_rel_err": max((checks.rel_err(bt.k1, k1_ref) for bt in chosen), default=math.inf),
        "k1_chain_rel_err": max((checks.rel_err(bt.chain, chain_ref) for bt in chosen),
                                default=math.inf),
        "k2_rel_err": max((k2_err(bt) for bt in chosen), default=math.inf),
        "burnin_loss_err": loss_err,
        "burnin_drop_err": drop_err,
        "verdicts_not_ok": float(sum(not bt.ok for bt in batteries)),
    }


def control_battery(conf: dict, seed: int, burnin_batch: int, links: int,
                    device: str) -> Battery:
    """The control in the port's place: the reference of run ``seed``'s
    inputs computed in the precision below the configuration's (K1's
    product in bf16, its chain of ``links`` links, K2 and the burn-in in
    float8), on ``device``."""
    a, b = inputs.matmul_operands(seed, conf["matmul_size"])
    q, k, v = inputs.attention_operands(seed, tuple(conf["flash_shape"]))
    c = conf["burnin"]
    params = inputs.burnin_params(seed, c["vocab"], c["d_model"], c["d_ff"], c["n_layers"])
    tokens = inputs.burnin_tokens(seed, c["vocab"], burnin_batch, c["seq_len"])
    k2 = ref_attention.control(q, k, v, causal=True, device=device)
    return Battery(
        ok=True,
        k1=ref_matmul.control(a, b, device),
        chain=ref_matmul.chain_control(a, b, links, device),
        k2=[k2] * conf["flash"]["calls"],
        losses=ref_burnin.losses(params, tokens, c["n_heads"], steps=c["steps"], lr=c["lr"],
                                 control=True),
    )


def make_gate(conf: dict, cards: int, device: Optional[str]):
    """The shipped gate over ``cards`` cards (or ``device``'s CPU ranks)."""
    from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate

    devices = [device] * cards if device else [f"cuda:{i}" for i in range(cards)]
    return IciHealthGate.tpu_defaults(devices=devices, matmul_size=conf["matmul_size"],
                                      payload_mb=conf["payload_mb"])


def warm(gate, probes: GateProbes, batteries: int) -> None:
    """Form the world, build and load the kernels and capture the matmul
    chain: one battery on the port's own inputs, then ``batteries`` on the
    seeded ones, every shape of the window among them. A verdict that is
    not ok here shows again in the window's."""
    gate.run()
    probes.install()
    for _ in range(batteries):
        probes.battery(record=False)


def memory_peak(gate, cards: int) -> int:
    """The fullest card's peak: this process's allocator peak on each card
    plus its rank's."""
    import torch

    per_card = {i: int(torch.cuda.max_memory_allocated(i)) for i in range(cards)}
    for name, peak in gate._world.run(devtrace.rank_memory_peak):
        if name.startswith("cuda:"):
            index = int(name.split(":")[1])
            per_card[index] = per_card.get(index, 0) + peak
    return max(per_card.values())


def probe_work(conf: dict) -> dict:
    """(FLOPs, bytes) one call of each probe asks for (``roofline``)."""
    mxu = conf["mxu"]
    flash = conf["flash"]
    return {
        "mxu": roofline.mxu_probe_work(conf["matmul_size"], mxu["chain"], mxu["iters"]),
        "flash": roofline.flash_probe_work(tuple(conf["flash_shape"]), True, flash["calls"]),
    }


def spread_note(values: list) -> dict:
    """n, p10, p50, p90 and max of ``values``, for the run's notes."""
    if len(values) < 2:
        return {"n": len(values)}
    deciles = statistics.quantiles(values, n=10)
    return {"n": len(values), "p10": round(deciles[0], 5), "p50": round(deciles[4], 5),
            "p90": round(deciles[8], 5), "max": round(max(values), 5)}


def span_notes(run: Run) -> None:
    """The spread of each span's seconds, into the run's notes."""
    run.notes["span_s"] = {name: spread_note([e - s for s, e in spans])
                           for name, spans in sorted(run.spans.items())}


@dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""

    end_to_end: dict
    attempted: int
    failed: int
    numbers: dict
    limits: dict
    run: Run
    memory_peak_bytes: int
    setup_s: float


def run_cell(ctx) -> Outcome:
    """One run of a gate cell (``ctx``: ``run.Context``)."""
    conf, traffic = ctx.config["gate"], ctx.traffic
    run = Run(trace=ctx.trace)
    run.notes.update(ctx.notes)
    run.work = probe_work(conf)
    gate = make_gate(conf, ctx.cards, ctx.device)
    probes = GateProbes(gate, conf, ctx.seed, run, traffic["sample_outputs"])
    try:
        warm(gate, probes, traffic["warmup_batteries"])
        traced = ctx.start_trace(gate._world)
        setup_s = ctx.setup_seconds()
        deadline = time.perf_counter() + ctx.seconds
        with ctx.window(run):
            start = time.perf_counter()
            while True:
                probes.battery()
                if time.perf_counter() >= deadline:
                    break
            window_s = time.perf_counter() - start
        ctx.stop_trace(traced, gate._world, run)
        peak = memory_peak(gate, ctx.cards) if ctx.device is None else 0
        probes.host_outputs()
    finally:
        probes.uninstall()
        gate.close()
    seconds = [b.seconds for b in probes.batteries]
    run.notes["battery_s"] = spread_note(seconds)
    span_notes(run)
    end_to_end = {"gate_s": window_s / len(seconds)}
    if len(seconds) >= 10:
        end_to_end["gate_p90_s"] = statistics.quantiles(seconds, n=10)[8]
    numbers = probes.numbers()
    return Outcome(
        end_to_end=end_to_end,
        attempted=len(seconds),
        failed=int(numbers["verdicts_not_ok"]),
        numbers=numbers,
        limits=ctx.config["limits"],
        run=run,
        memory_peak_bytes=peak,
        setup_s=setup_s,
    )
