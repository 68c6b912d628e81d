"""Launchers — port of ``src/repro/launch``: the in-situ driver
(``python -m repro_torch.launch.insitu``), the LM serving launcher
(``python -m repro_torch.launch.serve``) and the LM training launcher
(``python -m repro_torch.launch.train``)."""
