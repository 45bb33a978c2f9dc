"""Native (C++) host components of the port: the ImageNet batch decoder
(``dataloader``), built with g++ at first use into the package's
``_build/`` directory."""
