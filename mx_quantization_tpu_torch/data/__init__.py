"""Input pipelines: the ImageNet validation folder, CIFAR and latent-npz
datasets, repeated-augmentation sampling and 3-Augment."""
