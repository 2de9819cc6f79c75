"""Process groups, meshes and the collectives the port runs across ranks
(``mesh``), the ambient mesh the models read (``ctx``), and gradient
compression (``compression``)."""
