"""Observability, as far as the port has it: the one injectable clock
(:mod:`repro_torch.obs.clock`), a copy of ``repro.obs.clock`` that the
checkpointer, the heartbeat monitor and the straggler mitigator read.
Tracing, metrics and reports are not ported yet."""

from repro_torch.obs import clock

__all__ = ["clock"]
