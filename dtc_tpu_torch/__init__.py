"""dtc_tpu_torch — the PyTorch/CUDA port of dtc_tpu for NVIDIA Hopper.

Layout and module names mirror ``dtc_tpu/``. The package imports torch and
never jax, flax or any ``dtc_tpu`` module. Its entry points (``GPT``,
``generate``, ``ServingEngine``, ``train.trainer.train`` and the command
line ``python -m dtc_tpu_torch.main``) run on ``cuda`` unless the caller
asks for ``device="cpu"``.
"""
