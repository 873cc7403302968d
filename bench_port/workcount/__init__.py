"""The yardstick's arithmetic: the card's peaks, the least time of a
kernel call, and the work a cell's step needs, counted on the plain
reference."""
