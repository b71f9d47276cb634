"""The LM stack (the counterpart of `repro.models`): config, layers,
attention (GQA, MLA and cross-attention), the MoE FFN, the Mamba2 and
xLSTM mixers, blocks and the language model.  Ported: every block kind of
the JAX package and serving (prefill, decode); training and sharding
follow ROADMAP Queue 1 item 8 steps 8-9."""
