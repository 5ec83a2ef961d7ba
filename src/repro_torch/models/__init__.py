from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    pack_params,
    prefill_step,
    train_loss,
)

__all__ = ["init_params", "init_cache", "forward", "train_loss",
           "decode_step", "prefill_step", "pack_params"]
