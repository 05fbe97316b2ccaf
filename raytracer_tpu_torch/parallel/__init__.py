"""Multi-device rendering and training on torch.distributed (counterpart of
`raytracer_tpu/parallel/`): one process per rank, gloo on the CPU, NCCL on
CUDA devices."""
