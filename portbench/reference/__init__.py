"""The plain float32 reference that decides `correct`: the model families,
the augmentation, the losses, Adam and the metrics in plain PyTorch, with no
import of the program under test."""
