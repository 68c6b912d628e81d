"""Launchers — port of ``src/repro/launch``: the in-situ driver
(``python -m repro_torch.launch.insitu``) and the LM serving launcher
(``python -m repro_torch.launch.serve``)."""
