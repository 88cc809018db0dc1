"""Plain PyTorch references of what the benchmark's cells must produce. They
import nothing of the program, `depth_estimation_torch`."""
