"""Training: the DAMC stage-2 / stage-1 train step (``trainer``), the train
entry (``train_multimodal``), its step checkpoints and exports
(``checkpoint``) and its batch order (``sampler``)."""
