"""Entry points of the LM substrate (twin of the JAX package's LM examples):
`repro_torch.launch.serve_lm`, batched autoregressive sampling."""
