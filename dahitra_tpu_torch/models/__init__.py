"""Models of the port: DAHiTra (``newUNetTrans``) and ``define_g``."""
