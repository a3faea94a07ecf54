"""Layouts of tensors over a device mesh (counterpart of the JAX
package's ``dist/``): :mod:`repro_torch.dist.sharding`."""
