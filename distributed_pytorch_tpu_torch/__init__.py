"""PyTorch/CUDA port of distributed_pytorch_tpu, for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package mirrors its layout
(models/, ops/, data/, utils/, generate.py, serve.py, lm.py, train.py, ...)
and imports neither JAX nor the JAX package.  Entry
points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``.

Ported so far, each with its hand-written CUDA kernels under csrc/:
- serving: the dense transformer forward, the contiguous KV-cache generate
  path and the continuous batcher's core (decode attention,
  csrc/decode_attention.cu);
- LM training on one device: lm.py, lm_cli.py (flash attention,
  csrc/flash_attention.cu);
- paged serving: the paged KV pool with preemption and prefix caching (the
  paged instance of csrc/decode_attention.cu);
- VGG training: models/vgg.py, train.py, eval.py, cli.py, the CIFAR-10
  data path (the fused BN+ReLU backward, csrc/fused_bn.cu), and data
  parallel over torch.distributed, one process a device: parallel/
  (rendezvous, mesh, the gradient-sync strategies), sync-BN, launch.py;
- observability: utils/telemetry.py (the run's event stream),
  utils/monitor.py (SLO monitors, memory and compile lanes, postmortems),
  utils/logging.py, profiler traces (utils/tracing.py).
See ROADMAP.md for what follows.
"""
