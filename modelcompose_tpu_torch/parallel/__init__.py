"""Distribution over ``torch.distributed`` (counterpart of
modelcompose_tpu/parallel/): process-group set-up (``distributed``), the
(data, model) mesh and the split rules (``mesh``), the Megatron
tensor-parallel collectives (``tp``) and the served backbone that mirrors
the leader's calls onto the model group (``serving``)."""
