"""The schedules the optimizer tests run under (``tests/test_torch_optim.py``
against optax, ``tests/test_torch_optim_fused.py`` the fused route against
the chain leaf by leaf): each schedule's settings, read by
``quantize_tpu(_torch).optim.build_lr_scheduler`` at 3 steps an epoch."""

SCHEDULES = {
    "constant": {},
    "step": {"step_size": 2, "gamma": 0.5},
    "multistep": {"milestones": [1, 3], "gamma": 0.3},
    "exponential": {"gamma": 0.9},
    "cosine": {"t_max": 5},
    "cosine_warmup": {"warmup_epoch": 2, "warmup_lr": 1e-4},
    "linear_warmup": {"warmup_epoch": 2, "warmup_lr": 1e-4},
}
