"""dtc_tpu_torch — the PyTorch/CUDA port of dtc_tpu for NVIDIA Hopper.

Layout and module names mirror ``dtc_tpu/``. The package imports torch and
never jax, flax or any ``dtc_tpu`` module. Its entry points (``GPT``,
``generate``, ``ServingEngine``) run on ``cuda`` unless the caller asks for
``device="cpu"``.
"""
