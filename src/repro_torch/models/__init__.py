"""The LM stack (the counterpart of `repro.models`): config, layers,
attention (GQA and MLA), the MoE FFN, blocks and the language model.
Ported so far: the block kinds ``"attn"``, ``"moe"``, ``"mla"`` and
``"mla_moe"`` and serving (prefill, decode); the other mixers, training
and sharding follow ROADMAP Queue 1 item 8."""
