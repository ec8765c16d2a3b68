"""The plain reference of the codec in PyTorch and numpy: the encode's search
and fit, the quadtree's levels and the pyramid decode.  It imports nothing of
the program under test."""
