"""Host-side machinery around the training loop (fault tolerance) and the
hand-scheduled collectives on ``torch.distributed``
(:mod:`repro_torch.distributed.collectives`)."""
