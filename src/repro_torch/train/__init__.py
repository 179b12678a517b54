"""Training: ``DatasetProvider → Task → Trainer``, behind
:func:`repro_torch.train.fit`, as the reference's ``repro.train``.

    from repro_torch import train

    data = train.GraphEpochProvider(shapes=((96, 384), (128, 512)))
    task = train.NodeClassification.from_provider(data, model="gcn")
    result = train.fit(task, data, train.TrainerConfig(steps=50))

    # an LM: next-token loss on token batches
    data = train.TokenProvider(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=256, global_batch=8))
    result = train.fit(train.LMTask(cfg), data, train.TrainerConfig())

Tasks, trainers and the sampled provider (``SampledNodeProvider``: a
neighbour sampler behind the prefetch pipeline) run on the card unless
built with ``device="cpu"``.
"""
from repro_torch.train.providers import (DatasetProvider, GraphEpochProvider,
                                         SampledNodeProvider, TokenProvider)
from repro_torch.train.task import (GraphStatic, LMStatic, LMTask,
                                    NodeClassification, Task)
from repro_torch.train.trainer import (FitResult, Trainer, TrainerConfig,
                                       TrainState, fit)

__all__ = [
    "DatasetProvider",
    "GraphEpochProvider",
    "SampledNodeProvider",
    "TokenProvider",
    "Task",
    "GraphStatic",
    "NodeClassification",
    "LMStatic",
    "LMTask",
    "Trainer",
    "TrainerConfig",
    "TrainState",
    "FitResult",
    "fit",
]
