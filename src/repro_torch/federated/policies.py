"""Pluggable runtime policies for the federated message-passing engine.

The port's copy of ``repro.federated.policies``.  Participation
schedules stay host-side numpy with the reference's substreams, so one
seed gives the reference's schedule bit for bit; local updates and
compression act on tensors.  Three small registries, mirroring the
losses/regularizers pattern of ``repro_torch.api``:

  * **participation** — who is active each round.  A policy materializes
    the whole activity schedule up front (host-side numpy, deterministic
    in the seed), so the engine can scan over it and the determinism /
    ledger tests can reason about it as data:
      - ``full``        every client, every round (the dense oracle mode),
      - ``bernoulli``   independent per-round client sampling with rate p,
      - ``dropout``     permanent node failure (per-round hazard rate),
      - ``straggler``   sampled clients whose round lands ``delay`` rounds
                        late (their neighbours meanwhile use stale
                        messages),
      - ``fixed``       an explicit (rounds, nodes) mask (tests).

  * **local updates** — how much local work an active client does per
    round before messaging:
      - ``single``      one primal-update operator application (eq. 17 —
                        exactly Algorithm 1, the dense oracle mode),
      - ``prox``        ``num_steps`` repeated prox-descent applications
                        holding the received dual aggregate fixed
                        (FedProx-style local epochs).

  * **compression** — what a client's edge message looks like on the
    wire.  ``compress`` is the *simulated* channel (returns the
    dequantized values the receiver reconstructs); ``message_bytes`` is
    what the :class:`~repro_torch.federated.ledger.CommLedger` meters:
      - ``none``        float32 vectors (4n bytes),
      - ``int8``        per-message symmetric int8 quantization
                        (n + 4 bytes: payload + one float scale),
      - ``topk``        magnitude top-k sparsification (8 bytes per kept
                        coordinate: value + index).

All policies are frozen dataclasses — hashable, and their repr is the
checkpoint fingerprint's record of them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, ClassVar

import numpy as np
import torch

PARTICIPATION: dict[str, type] = {}
LOCAL_UPDATES: dict[str, type] = {}
COMPRESSIONS: dict[str, type] = {}


def _make_registry_resolver(registry: dict, base: type, kind: str):
    def get(spec, **kwargs):
        if isinstance(spec, base):
            if kwargs:
                raise TypeError(
                    f"{kind} kwargs only apply to registry names")
            return spec
        if isinstance(spec, str):
            try:
                cls = registry[spec]
            except KeyError:
                raise ValueError(f"unknown {kind} {spec!r}; "
                                 f"registered: {sorted(registry)}")
            return cls(**kwargs)
        raise TypeError(
            f"{kind} must be a {base.__name__} or a registry name, "
            f"got {spec!r}")
    return get


def _register(registry: dict):
    def outer(name: str):
        def deco(cls):
            cls.name = name
            registry[name] = cls
            return cls
        return deco
    return outer


register_participation = _register(PARTICIPATION)
register_local_update = _register(LOCAL_UPDATES)
register_compression = _register(COMPRESSIONS)


# ---------------------------------------------------------------------------
# Participation: who is active each round
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParticipationPolicy:
    """Activity schedule factory: (rng, rounds, nodes) -> {0,1} mask."""

    name: ClassVar[str] = "base"

    def schedule(self, rng: np.random.Generator, num_rounds: int,
                 num_nodes: int) -> np.ndarray:
        """(num_rounds, num_nodes) float32 activity mask."""
        raise NotImplementedError


@register_participation("full")
@dataclasses.dataclass(frozen=True)
class FullParticipation(ParticipationPolicy):
    """Every client active every round — the synchronous dense oracle."""

    def schedule(self, rng, num_rounds, num_nodes):
        del rng
        return np.ones((num_rounds, num_nodes), np.float32)


@register_participation("bernoulli")
@dataclasses.dataclass(frozen=True)
class BernoulliParticipation(ParticipationPolicy):
    """Independent per-round client sampling: active with probability p."""

    p: float = 0.5

    def schedule(self, rng, num_rounds, num_nodes):
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"need 0 < p <= 1, got {self.p}")
        return (rng.random((num_rounds, num_nodes))
                < self.p).astype(np.float32)


def _substreams(rng: np.random.Generator, k: int):
    """k independent child generators drawn with O(1) state consumption.

    Policies that need several (rounds, nodes) draws must give each its
    own stream: a second draw from one generator starts at an offset
    that depends on the first draw's size, which would make schedule
    *prefixes* horizon-dependent — and resuming a checkpointed run with
    an extended ``num_rounds`` must replay the executed prefix exactly.
    Row-major fills from independent children are prefix-stable.
    """
    seeds = rng.integers(np.iinfo(np.int64).max, size=k)
    return [np.random.default_rng(int(s)) for s in seeds]


@register_participation("dropout")
@dataclasses.dataclass(frozen=True)
class DropoutParticipation(ParticipationPolicy):
    """Permanent node failure: each round a surviving node dies with
    probability ``rate``; surviving nodes are sampled with rate ``p``."""

    rate: float = 0.01
    p: float = 1.0

    def schedule(self, rng, num_rounds, num_nodes):
        r_die, r_sample = _substreams(rng, 2)
        survive = r_die.random((num_rounds, num_nodes)) >= self.rate
        alive = np.cumprod(survive, axis=0)          # once 0, always 0
        active = alive.astype(np.float32)
        if self.p < 1.0:
            active *= (r_sample.random((num_rounds, num_nodes))
                       < self.p).astype(np.float32)
        return active


@register_participation("straggler")
@dataclasses.dataclass(frozen=True)
class StragglerParticipation(ParticipationPolicy):
    """Sampled clients with straggler delay: each sampled round runs
    on time with probability 1 - p_slow, otherwise it lands ``delay``
    rounds late (slipping past the horizon drops it).  Until the late
    round lands, neighbours keep consuming the client's stale message —
    exactly the engine's inactive semantics."""

    p: float = 0.8
    p_slow: float = 0.3
    delay: int = 3

    def schedule(self, rng, num_rounds, num_nodes):
        if self.delay < 1:
            raise ValueError(f"need delay >= 1, got {self.delay}")
        r_sample, r_slow = _substreams(rng, 2)
        sampled = r_sample.random((num_rounds, num_nodes)) < self.p
        slow = r_slow.random((num_rounds, num_nodes)) < self.p_slow
        on_time = sampled & ~slow
        late = sampled & slow
        active = on_time.copy()
        if self.delay < num_rounds:
            active[self.delay:] |= late[:-self.delay]
        return active.astype(np.float32)


@register_participation("fixed")
@dataclasses.dataclass(frozen=True)
class FixedSchedule(ParticipationPolicy):
    """An explicit activity mask (tests / replaying recorded schedules).

    ``mask`` is a (rounds, nodes) tuple-of-tuples (hashable, so configs
    carrying it stay frozen); rounds beyond the mask repeat the last
    row.
    """

    mask: tuple = ()

    def schedule(self, rng, num_rounds, num_nodes):
        del rng
        mask = np.asarray(self.mask, np.float32)
        if mask.ndim != 2 or mask.shape[1] != num_nodes:
            raise ValueError(
                f"fixed mask must be (rounds, {num_nodes}), "
                f"got {mask.shape}")
        if mask.shape[0] < num_rounds:
            tail = np.repeat(mask[-1:], num_rounds - mask.shape[0], axis=0)
            mask = np.concatenate([mask, tail], axis=0)
        return mask[:num_rounds]


# ---------------------------------------------------------------------------
# Local updates: per-round client work
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalUpdatePolicy:
    """How an active client turns (w, received dual aggregate) into w+."""

    name: ClassVar[str] = "base"

    def apply(self, prox: Callable, w: torch.Tensor, dtu: torch.Tensor,
              tau: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@register_local_update("single")
@dataclasses.dataclass(frozen=True)
class SingleStep(LocalUpdatePolicy):
    """One primal-update operator application — Algorithm 1 eq. 17."""

    def apply(self, prox, w, dtu, tau):
        return prox(w - tau[:, None] * dtu)


@register_local_update("prox")
@dataclasses.dataclass(frozen=True)
class MultiProxSteps(LocalUpdatePolicy):
    """``num_steps`` repeated prox-descent steps on the local objective,
    holding the round's received dual aggregate D^T u fixed (the
    communication already happened).  ``num_steps=1`` is exactly
    ``single``; more steps trade local compute for rounds."""

    num_steps: int = 4

    def apply(self, prox, w, dtu, tau):
        if self.num_steps < 1:
            raise ValueError(f"need num_steps >= 1, got {self.num_steps}")
        z = w
        for _ in range(self.num_steps):
            z = prox(z - tau[:, None] * dtu)
        return z


# ---------------------------------------------------------------------------
# Compression: what crosses an edge
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Simulated message channel + its metered wire size."""

    name: ClassVar[str] = "base"

    def compress(self, msg: torch.Tensor) -> torch.Tensor:
        """(..., n) messages -> the values the receiver reconstructs."""
        raise NotImplementedError

    def message_bytes(self, num_features: int) -> float:
        """Wire bytes for one n-dimensional message."""
        raise NotImplementedError


@register_compression("none")
@dataclasses.dataclass(frozen=True)
class NoCompression(CompressionPolicy):
    """Exact float32 messages — the dense oracle mode."""

    def compress(self, msg):
        return msg

    def message_bytes(self, num_features):
        return 4.0 * num_features


@register_compression("int8")
@dataclasses.dataclass(frozen=True)
class Int8Quantization(CompressionPolicy):
    """Per-message symmetric int8 quantization: q = round(m / s) with
    s = max|m| / 127, dequantized on receive.  Wire: n int8 payload
    bytes + one float32 scale."""

    def compress(self, msg):
        # torch.round, like jnp.round, rounds half to even
        scale = torch.amax(torch.abs(msg), dim=-1, keepdim=True) / 127.0
        safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(msg / safe), -127.0, 127.0)
        return q * safe

    def message_bytes(self, num_features):
        return float(num_features) + 4.0


@register_compression("topk")
@dataclasses.dataclass(frozen=True)
class TopKSparsification(CompressionPolicy):
    """Keep the ceil(fraction * n) largest-magnitude coordinates of each
    message, zero the rest.  Wire: 8 bytes (float32 value + int32 index)
    per kept coordinate."""

    fraction: float = 0.5

    def _k(self, num_features: int) -> int:
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"need 0 < fraction <= 1, got {self.fraction}")
        return max(1, int(math.ceil(self.fraction * num_features)))

    def compress(self, msg):
        n = msg.shape[-1]
        k = self._k(n)
        if k >= n:
            return msg
        mag = torch.abs(msg)
        # k-th largest magnitude per message; ties keep the earlier coord
        # (the reference's sort and rank, not torch.topk, whose ties fall
        # otherwise)
        kth = torch.sort(mag, dim=-1).values[..., n - k][..., None]
        rank = torch.cumsum((mag >= kth).to(torch.int32), dim=-1)
        keep = (mag >= kth) & (rank <= k)
        return torch.where(keep, msg, torch.zeros_like(msg))

    def message_bytes(self, num_features):
        return 8.0 * self._k(num_features)


get_participation = _make_registry_resolver(
    PARTICIPATION, ParticipationPolicy, "participation policy")
get_local_update = _make_registry_resolver(
    LOCAL_UPDATES, LocalUpdatePolicy, "local-update policy")
get_compression = _make_registry_resolver(
    COMPRESSIONS, CompressionPolicy, "compression policy")
