"""The GUI of the port: counterpart of the root `gui/` package.

`app` is the Tkinter app (menu, human play, training, watch); `workers`
holds its thread bodies without tkinter.  Start it with ``python -m
bbx_torch.gui`` (or ``bbx-torch-gui``).
"""
