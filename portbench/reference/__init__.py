"""The plain float32 reference of the benchmark: the split cGAN of the
HuSCF-GAN paper's Table 3, its training step, the paper's Eq. 13-16
federation round, and the operation and byte counts behind the
rooflines. Plain PyTorch and NumPy only: nothing here imports the
program under test or JAX."""
