"""The LM stack (the counterpart of `repro.models`): config, layers,
attention (GQA, MLA and cross-attention), the MoE FFN (its scatter and
all-to-all paths), the Mamba2 and xLSTM mixers, blocks and the language
model, for serving (prefill, decode) and training, on one device or
sharded over a mesh (`lm.shard_model`, `sharding.rules`)."""
