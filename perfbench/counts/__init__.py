"""Operations and bytes of each kernel's problem, from the cell's shapes
alone: each input byte counted once and each output byte once, whatever a
kernel reads again, and the operations the arithmetic needs, whatever a
kernel recomputes.  So a kernel's roofline share reads the same work
whichever design computes it.  ``KERNEL`` is the fragment of the kernel's
name in a profiler trace."""
