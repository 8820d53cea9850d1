"""AdaPT core of the port: fixed-point words, init, the precision
controller with PushDown and PushUp, and the regularizer."""
