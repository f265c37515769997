from .topology import (DP_AXIS, DP_OUTER_AXIS, EP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS,
                       Topology, TopologySpec, get_topology, reset_topology,
                       set_topology)
