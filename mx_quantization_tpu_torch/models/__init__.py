"""Models of the port (slice 1: DiT)."""

from .dit import (DiT, DiT_models, DiTConfig, DiTQuantConfig, dit_forward,
                  dit_forward_with_cfg, get_2d_sincos_pos_embed, init_dit,
                  timestep_embedding)

__all__ = ["DiT", "DiT_models", "DiTConfig", "DiTQuantConfig", "dit_forward",
           "dit_forward_with_cfg", "get_2d_sincos_pos_embed", "init_dit",
           "timestep_embedding"]
