"""The benchmark's plain reference: ``mhr`` reads HRTF data sets and
``binaural`` renders headphone scenes from the inputs alone.  It imports
nothing of the program."""
