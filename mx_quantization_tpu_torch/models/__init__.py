"""Models of the port: DiT (slice 1) and PixArt-alpha (slice 2)."""

from .dit import (DiT, DiT_models, DiTConfig, DiTQuantConfig, dit_forward,
                  dit_forward_with_cfg, get_2d_sincos_pos_embed, init_dit,
                  timestep_embedding)
from .pixart import (PixArt, PixArtConfig, PixArtQuantConfig, init_pixart,
                     pixart_forward)

__all__ = ["DiT", "DiT_models", "DiTConfig", "DiTQuantConfig", "PixArt",
           "PixArtConfig", "PixArtQuantConfig", "dit_forward",
           "dit_forward_with_cfg", "get_2d_sincos_pos_embed", "init_dit",
           "init_pixart", "pixart_forward", "timestep_embedding"]
