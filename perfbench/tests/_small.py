"""Small runs of the benchmark's cells for CPU tests: each cell with its
model cut in every width (the structure kept: GQA, QKV bias, experts with
a pad, the shared expert) and short prompts, and the sweep over the first
ids of the space."""
SMALL = {
    "qwen2-moe-a2.7b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                            head_dim=16, d_ff=96, vocab=256, n_experts=6,
                            top_k=2, expert_ff=32, expert_pad=2),
    "qwen2.5-14b-6l": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=128, vocab=256),
}
SMALL_MIX = {"batch": 2, "seq": 48}
# cell -> (model override, traffic override)
CELLS = {
    "qwen2moe.prefill": (SMALL["qwen2-moe-a2.7b"], SMALL_MIX),
    "qwen2moe.dse_sweep": (None, {"stop": 40_000, "chunk": 8_192}),
    "qwen25.train": (SMALL["qwen2.5-14b-6l"], SMALL_MIX),
    "qwen25.prefill": (SMALL["qwen2.5-14b-6l"], SMALL_MIX),
}

# limits for the training cell at this size (the file's are read at the
# cell's own): sound CPU runs read loss 0-8e-8, gradient 2e-8-1e-7 and
# change 1e-5-3e-5 here, each fault 1e-4 or more on one of them
SMALL_LIMITS = {"qwen25.train": {"compare": {
    "loss_gap": {"limit": 1e-6}, "grad_gap": {"limit": 1e-5},
    "change_gap": {"limit": 3e-4}}}}
