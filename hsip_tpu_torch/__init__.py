"""hsip_tpu_torch — the flame-front tracker in PyTorch and CUDA.

A port of :mod:`hsip_tpu` (JAX on a TPU) to PyTorch on an NVIDIA Hopper
card. The two Pallas kernels of the per-file path become hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` at first use; everything around
them is plain PyTorch on tensors with an explicit ``device``.

Layout (mirrors ``hsip_tpu``):

* ``kernels/preprocess``      — band chain: diff, opening, blur, Sobel, gradient
* ``kernels/cuda_preprocess`` — the fused band-preprocess CUDA kernel
* ``kernels/unpack``          — packed MRAW bytes → pixels on the device
* ``track/scan``              — map phase, device scan, ``track_video``
* ``track/device_scan``       — the tracker state machine in plain PyTorch
* ``track/cuda_scan``         — the tracking-scan CUDA kernel
* ``pipeline``                — ``process_video_file``

Host-side layers that never touched JAX (the MRAW codec, video and
collection objects, the float64 host scan, the table writer, figures) are
reused from :mod:`hsip_tpu` by import.
"""

__version__ = "0.1.0"
