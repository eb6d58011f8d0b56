"""Launch layer of the port: the serving runtime and CLI, the device
meshes, the cell plans and the training CLI.  Import the submodules
(``repro_torch.launch.mesh``, ``.steps``, ``.train``, ``.serve``,
``.service``) directly."""
