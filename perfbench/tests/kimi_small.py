"""Kimi Linear at the CPU tests' size, merged over the configuration
file's keys: hidden 256, the published head widths (KDA 128 for q, k and
v; MLA 128 nope + 64 rope, v 128, kv latent 512), 2 KDA heads and 2 MLA
heads, 5 layers (KDA, KDA, MLA, KDA, MLA),
layer 0 dense, 4 held of 32 experts, top-4, 2 sequences of 128 tokens (two
chunks each)."""

import json
from pathlib import Path

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "configs"
                     / "kimi-linear-ep8.json").read_text())
LINEAR = dict(CONFIG["linear_attn_config"], num_heads=2,
              kda_layers=[1, 2, 4], full_attn_layers=[3, 5])
SMALL = dict(CONFIG, hidden_size=256, intermediate_size=512,
             moe_intermediate_size=128, vocab_size=512, num_hidden_layers=5,
             num_attention_heads=2, num_key_value_heads=2, num_experts=4,
             num_experts_per_token=4, linear_attn_config=LINEAR,
             published={"num_experts": 32})
BATCH, SEQ = 2, 128
KDA_LAYERS, MLA_LAYERS, MOE_LAYERS = [0, 1, 3], [2, 4], [1, 2, 3, 4]
