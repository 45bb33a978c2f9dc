"""Models of the port: DiT (slice 1), PixArt-alpha (slice 2) and DeiT
(slice 7)."""

from .dit import (DiT, DiT_models, DiTConfig, DiTQuantConfig, dit_forward,
                  dit_forward_with_cfg, get_2d_sincos_pos_embed, init_dit,
                  timestep_embedding)
from .pixart import (PixArt, PixArtConfig, PixArtQuantConfig, init_pixart,
                     pixart_forward)
from .vit import VIT_CONFIGS, ViT, VitConfig, VitQuantConfig, init_vit, \
    vit_forward

__all__ = ["DiT", "DiT_models", "DiTConfig", "DiTQuantConfig", "PixArt",
           "PixArtConfig", "PixArtQuantConfig", "VIT_CONFIGS", "ViT",
           "VitConfig", "VitQuantConfig", "dit_forward",
           "dit_forward_with_cfg", "get_2d_sincos_pos_embed", "init_dit",
           "init_pixart", "init_vit", "pixart_forward", "timestep_embedding",
           "vit_forward"]
