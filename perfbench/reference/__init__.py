"""The plain reference of the benchmark: a transmitter that makes every
input from the seed (``transmitter``) and a receiver in plain PyTorch on the
CPU (``receiver``) that works out again everything the port derives from
those inputs. It imports neither JAX nor any package of this repository."""
