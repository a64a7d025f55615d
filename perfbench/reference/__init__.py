"""Plain PyTorch references: the models as the configuration files describe
them, in float32, with no kernel, cache or batching of the program.  They
import nothing of the program and take only what the benchmark makes."""
