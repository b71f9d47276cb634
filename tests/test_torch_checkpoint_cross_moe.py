"""`test_torch_checkpoint_cross.py`'s resume across the packages for
reduced deepseek-v3-671b with AdamW (its ``router_bias`` among the
leaves): a JAX run's checkpoint resumed by the port
(`test_torch_checkpoint_cross_moe_back.py`: the reverse), in files of
their own so that pytest-xdist's workers share the cases."""

from test_torch_checkpoint_cross import resume_across


def test_a_moe_checkpoint_resumes_in_the_other_package(tmp_path):
    resume_across(tmp_path, "deepseek-v3-671b", "adamw", "jax->port")
