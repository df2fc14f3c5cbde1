"""The benchmark's yardstick: the plain reference that decides ``correct``
and the frozen arithmetic of the metrics. Nothing here imports the port;
``frozen_port`` is a copy of it that runs only plain PyTorch."""
