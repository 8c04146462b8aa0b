"""Training of the port's LMs (twin of `repro.train`): AdamW, int8 gradient
compression and the train step."""
