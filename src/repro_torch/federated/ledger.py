"""CommLedger: metered communication cost of a federated run.

The port's copy of ``repro.federated.ledger``.  The paper's
message-passing implementation exchanges, per round and per edge
{i, j}:

  * **up** (client -> dual owner): the dst endpoint's compressed primal
    message z^(j) = 2 w^(j)+ - w^(j), sent when j is active, and
  * **down** (dual owner -> client): the refreshed dual u_e broadcast by
    the owning (src) endpoint after its dual update, float32.

The engine records, for every round, how many of each crossed the
network and how many bytes they cost under the configured compression
policy: float32 meters, computed as the reference computes them (a
message count times a per-message cost, in float32), so both packages'
ledgers agree bit for bit even where the byte totals pass 2^24.
Cumulative bytes at round t pairs with the objective trace at round t.

The ledger is a dataclass of plain tensors, so it checkpoints through
``repro_torch.checkpoint`` and concatenates across resumed segments.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CommLedger:
    """Per-round communication meter (all tensors shape (rounds,)).

    Attributes:
      up_msgs:    node->owner primal messages sent that round.
      up_bytes:   their wire cost under the run's compression policy.
      down_msgs:  owner->node dual broadcasts sent that round.
      down_bytes: their wire cost (float32, never compressed).
    """

    up_msgs: torch.Tensor
    up_bytes: torch.Tensor
    down_msgs: torch.Tensor
    down_bytes: torch.Tensor

    # -- construction --------------------------------------------------------
    @classmethod
    def empty(cls, device=None) -> "CommLedger":
        z = torch.zeros((0,), dtype=torch.float32, device=device)
        return cls(up_msgs=z, up_bytes=z, down_msgs=z, down_bytes=z)

    @classmethod
    def concat(cls, ledgers) -> "CommLedger":
        """Stitch per-segment ledgers into one run-length ledger."""
        ledgers = list(ledgers)
        if not ledgers:
            return cls.empty()
        return cls(*(torch.cat([getattr(led, f.name) for led in ledgers])
                     for f in dataclasses.fields(cls)))

    # -- aggregates ----------------------------------------------------------
    @property
    def num_rounds(self) -> int:
        return int(self.up_msgs.shape[0])

    @property
    def total_bytes(self) -> float:
        return float(torch.sum(self.up_bytes) + torch.sum(self.down_bytes))

    @property
    def total_messages(self) -> float:
        return float(torch.sum(self.up_msgs) + torch.sum(self.down_msgs))

    def cumulative_bytes(self) -> np.ndarray:
        """(rounds,) total bytes on the wire up to and including round t —
        the x-axis of a communication-vs-accuracy curve."""
        per_round = (self.up_bytes.cpu().numpy()
                     + self.down_bytes.cpu().numpy())
        return np.cumsum(per_round)

    def export_obs(self) -> None:
        """Mirror the run's wire totals into the obs registry (the
        reference's metric names).

        All values are finite even for a zero-round ledger:
        ``summary()`` already defines ``bytes_per_round`` as 0.0 when
        no rounds ran, and the cumulative gauge falls back to 0.0 when
        ``cumulative_bytes()`` is empty.
        """
        from repro_torch import obs
        if not obs.enabled():
            return
        s = self.summary()
        obs.counter("repro_federated_rounds_total",
                    help="federated communication rounds run"
                    ).inc(s["rounds"])
        obs.counter("repro_federated_up_bytes_total",
                    help="client->owner primal message bytes"
                    ).inc(s["up_bytes"])
        obs.counter("repro_federated_down_bytes_total",
                    help="owner->client dual broadcast bytes"
                    ).inc(s["down_bytes"])
        obs.gauge("repro_federated_bytes_per_round",
                  help="mean wire bytes per round of the last run"
                  ).set(s["bytes_per_round"])
        cum = self.cumulative_bytes()
        obs.gauge("repro_federated_cumulative_bytes",
                  help="total wire bytes of the last run"
                  ).set(float(cum[-1]) if cum.size else 0.0)

    def summary(self) -> dict[str, float]:
        """Flat float dict (JSON/CSV-ready) of the run's totals."""
        return {
            "rounds": float(self.num_rounds),
            "up_messages": float(torch.sum(self.up_msgs)),
            "up_bytes": float(torch.sum(self.up_bytes)),
            "down_messages": float(torch.sum(self.down_msgs)),
            "down_bytes": float(torch.sum(self.down_bytes)),
            "total_bytes": self.total_bytes,
            "bytes_per_round": (self.total_bytes / self.num_rounds
                                if self.num_rounds else 0.0),
        }
