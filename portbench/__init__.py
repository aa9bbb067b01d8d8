"""The benchmark of ``levelgan_torch`` on one NVIDIA H100 (see README.md)."""
