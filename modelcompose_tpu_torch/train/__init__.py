"""Training: the DAMC stage-2 / stage-1 train step (``trainer``) and the
train entry's model and batch builders (``train_multimodal``)."""
