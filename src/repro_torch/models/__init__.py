"""The LM substrate (twin of `repro.models`): the RWKV-6 family's serving
path — `model.prefill_logits`, `model.init_decode_state`, `model.decode_step`."""
