from .checkpoint import (export_reference_checkpoint, latest_checkpoint, load_checkpoint,
                         load_jax_checkpoint, load_params_any, save_checkpoint)
from .evaluate import do_evaluate, make_val_fn, render_view
from .loss import mask_alpha_loss, rgb_loss
from .solver import (make_frozen_mask, make_lr_schedule, make_optimizer,
                     make_warmup_multistep)
from .trainer import (CamTables, CompactPool, StepMetrics, TrainBatch, do_train,
                      training_spec,
                      make_decode, make_pool, make_train_epoch, make_train_step,
                      pool_camera_num, sort_batch_by_hit, split_compact_bundle)

__all__ = [
    "export_reference_checkpoint", "latest_checkpoint", "load_checkpoint",
    "load_jax_checkpoint", "load_params_any", "save_checkpoint",
    "do_evaluate", "make_val_fn", "render_view", "mask_alpha_loss", "rgb_loss",
    "make_frozen_mask", "make_lr_schedule", "make_optimizer", "make_warmup_multistep",
    "CamTables", "CompactPool", "StepMetrics", "TrainBatch", "do_train", "make_decode",
    "make_pool", "make_train_epoch", "make_train_step", "pool_camera_num",
    "sort_batch_by_hit", "split_compact_bundle", "training_spec",
]
