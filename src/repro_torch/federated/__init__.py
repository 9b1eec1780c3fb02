"""Federated message-passing runtime (paper §3-4 as an actual protocol).

The port's ``repro.federated``, on the problem's device (the CUDA card by
default).

Executes Algorithm 1 as round-based per-node clients exchanging edge
messages — with partial participation, straggler delay, node dropout,
multiple local updates, message compression, and a per-round
communication-cost ledger:

    from repro_torch.federated import FederatedConfig, run_federated

    result = run_federated(problem, FederatedConfig(
        num_rounds=500, rho=1.9, participation="bernoulli",
        compression="int8"))
    result.w, result.objective, result.ledger.summary()

The synchronous full-participation mode is an exact oracle for the dense
backend (locked down by the ``federated_sync`` column of the port's
conformance suite); it is also reachable as
``SolverConfig(backend="federated")`` through the unified solver.
"""
from repro_torch.federated.engine import (FederatedConfig,
                                          FederatedResult, FederatedState,
                                          has_checkpoint,
                                          participation_schedule,
                                          run_federated)
from repro_torch.federated.ledger import CommLedger
from repro_torch.federated.policies import (
    COMPRESSIONS, LOCAL_UPDATES, PARTICIPATION, BernoulliParticipation,
    CompressionPolicy, DropoutParticipation, FixedSchedule,
    FullParticipation, Int8Quantization, LocalUpdatePolicy, MultiProxSteps,
    NoCompression, ParticipationPolicy, SingleStep, StragglerParticipation,
    TopKSparsification, get_compression, get_local_update,
    get_participation, register_compression, register_local_update,
    register_participation)

__all__ = [
    "BernoulliParticipation", "COMPRESSIONS", "CommLedger",
    "CompressionPolicy", "DropoutParticipation", "FederatedConfig",
    "FederatedResult", "FederatedState", "FixedSchedule",
    "FullParticipation", "Int8Quantization", "LOCAL_UPDATES",
    "LocalUpdatePolicy", "MultiProxSteps", "NoCompression",
    "PARTICIPATION", "ParticipationPolicy", "SingleStep",
    "StragglerParticipation", "TopKSparsification", "get_compression",
    "get_local_update", "get_participation", "has_checkpoint",
    "participation_schedule", "register_compression",
    "register_local_update", "register_participation", "run_federated",
]
