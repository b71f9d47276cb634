"""`test_torch_checkpoint_cross_moe.py`'s reverse: the port's checkpoint
of reduced deepseek-v3-671b with AdamW resumed by JAX's loop."""

from test_torch_checkpoint_cross import resume_across


def test_a_moe_checkpoint_resumes_in_jax(tmp_path):
    resume_across(tmp_path, "deepseek-v3-671b", "adamw", "port->jax")
