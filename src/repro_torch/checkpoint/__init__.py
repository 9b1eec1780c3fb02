"""Checkpoints of nested tensors: npz payload + json manifest
(:mod:`repro_torch.checkpoint.checkpoint`)."""
