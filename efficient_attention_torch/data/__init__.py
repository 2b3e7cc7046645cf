"""Data: image folders, CIFAR, the uint8 cache, the samplers and the image
loader, RandAugment, mixup and erasing; the text datasets and dictionaries."""
