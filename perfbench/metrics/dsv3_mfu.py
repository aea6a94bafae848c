"""dsv3_mfu: a DeepSeek-V3 prefill against one card's bf16 peak, read as
``mimo_mfu`` reads MiMo-V2-Flash's: the model's work a pass, counted by its
route file (``Dsv3Mla24.pass_flops``: the kept 2:4 products of MLA, the
dense FFNs, the shared and the held routed experts, the dense router, the
causal attention core, the last positions' head) over the window's time a
pass, in %."""

from perfbench.metrics.mimo_mfu import read  # noqa: F401
