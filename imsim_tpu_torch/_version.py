"""The port's version: the IMSIMVER card of its raw amp files."""
__version__ = "0.1.0+torch"
