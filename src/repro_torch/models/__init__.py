"""The LM stack (the counterpart of `repro.models`): config, layers,
attention, blocks and the language model.  Ported so far: the dense
self-attention block (kind ``"attn"``) and serving (prefill, decode);
the other mixers and training follow ROADMAP Queue 1 item 8."""
