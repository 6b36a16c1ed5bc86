"""Config loading, and weights from JAX parameter trees and released checkpoints."""
