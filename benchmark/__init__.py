"""The benchmark of the PyTorch/CUDA port (``ppr_diffphys_torch``): see
``README.md`` beside this file and ``BENCHMARK.json`` at the checkout's
root."""
