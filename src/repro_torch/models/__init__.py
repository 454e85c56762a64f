"""Models of the port: the dense GQA decoder (lm.py) and its parts."""
