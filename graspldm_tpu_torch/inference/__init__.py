from .pipeline import (
    decode_and_postprocess,
    ldm_generate,
    pack_generation_weights,
    trajectory_decode_indices,
    vae_generate,
)

__all__ = ["decode_and_postprocess", "ldm_generate", "pack_generation_weights",
           "trajectory_decode_indices", "vae_generate"]
