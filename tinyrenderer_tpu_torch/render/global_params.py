"""GlobalGPUParams: runtime-reflected shading parameters.

The reference's tiny uniform visible to all shaders, edited live through
the reflection-driven GUI. The dataclass is the reflected host value and
``to_device`` packs it into the frame's params vector on the engine's
device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..editor.params import ui_param
from . import frame as framelib


@dataclass
class GlobalParams:
    exposure: float = field(default=1.0,
                            metadata=ui_param(min=0.0, max=8.0))
    tone_mapping_type: int = field(default=1,
                                   metadata=ui_param(min=0, max=3))
    ssr_thickness: float = field(default=0.25,
                                 metadata=ui_param(min=0.0, max=2.0))
    ssr_strength: float = field(default=0.0,
                                metadata=ui_param(min=0.0, max=1.0))
    # Live shadow compare bias (NDC units; + = toward lit / acne removal).
    # The reference declares this knob but never reads it in a shader;
    # here it is functional.
    shadow_bias: float = field(default=0.0,
                               metadata=ui_param(min=-0.01, max=0.01))

    def to_device(self, device) -> torch.Tensor:
        """The float32 (NUM_PARAMS,) vector of ``frame.PARAM_*`` on
        ``device``."""
        v = [0.0] * framelib.NUM_PARAMS
        v[framelib.PARAM_EXPOSURE] = float(self.exposure)
        v[framelib.PARAM_TONE_TYPE] = float(self.tone_mapping_type)
        v[framelib.PARAM_SSR_THICKNESS] = float(self.ssr_thickness)
        v[framelib.PARAM_SSR_STRENGTH] = float(self.ssr_strength)
        v[framelib.PARAM_SHADOW_BIAS] = float(self.shadow_bias)
        return torch.tensor(v, dtype=torch.float32, device=device)


@dataclass
class GlobalCPUParams:
    """The reference's CPU-side parameters (unused there; kept for
    parity)."""

    shadow_bias: float = field(default=0.0, metadata=ui_param(min=0.0, max=0.1))
    scale: float = field(default=1.0, metadata=ui_param(min=0.0, max=10.0))
