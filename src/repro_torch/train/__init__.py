"""repro_torch.train — optimizer, train step, checkpointing (counterpart of
:mod:`repro.train`): AdamW with warmup-cosine and clipping, microbatch
accumulation and bf16 gradient compression, async atomic checkpoints in the
reference's on-disk layout with elastic restore."""
