"""tinyllama-1.1b-swa — sliding-window variant (beyond assignment).

Same architecture as tinyllama-1.1b with a 4096-token attention window, so
the dense family decodes long sequences from a bounded ring-buffer cache.
"""

import dataclasses

from repro_torch.configs.tinyllama_1_1b import CONFIG as _BASE, SMOKE as _SMOKE

CONFIG = dataclasses.replace(
    _BASE, name="tinyllama-1.1b-swa", attn="sliding", window=4096)

SMOKE = dataclasses.replace(
    _SMOKE, name="tinyllama-swa-smoke", attn="sliding", window=32)
