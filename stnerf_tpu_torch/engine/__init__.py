from .checkpoint import load_checkpoint, save_checkpoint
from .loss import mask_alpha_loss, rgb_loss
from .solver import (make_frozen_mask, make_lr_schedule, make_optimizer,
                     make_warmup_multistep)
from .trainer import (CamTables, CompactPool, StepMetrics, TrainBatch, do_train,
                      make_decode, make_pool, make_train_epoch, make_train_step,
                      sort_batch_by_hit, split_compact_bundle)

__all__ = [
    "load_checkpoint", "save_checkpoint", "mask_alpha_loss", "rgb_loss",
    "make_frozen_mask", "make_lr_schedule", "make_optimizer", "make_warmup_multistep",
    "CamTables", "CompactPool", "StepMetrics", "TrainBatch", "do_train", "make_decode",
    "make_pool", "make_train_epoch", "make_train_step", "sort_batch_by_hit",
    "split_compact_bundle",
]
