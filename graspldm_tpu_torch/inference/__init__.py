from .pipeline import (
    decode_and_postprocess,
    ldm_generate,
    pack_generation_weights,
    vae_generate,
)

__all__ = ["decode_and_postprocess", "ldm_generate", "pack_generation_weights", "vae_generate"]
