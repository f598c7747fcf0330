"""Azure ML implementation of the EndpointClient protocol (import-gated; a
copy of ``dct_tpu/deploy/azure.py``: the Azure SDK is imported only when a
client is built).

Binds the rollout state machine to Azure Managed Online Endpoints with the
same resources the reference uses: ``Standard_DS2_v2`` x1 instances and the
openmpi Ubuntu inference base image (dags/azure_manual_deploy.py:154-162,
azure_auto_deploy.py:134-146). Credentials come from the standard env vars
(AZURE_TENANT_ID / AZURE_CLIENT_ID / AZURE_CLIENT_SECRET via
ClientSecretCredential, plus AZURE_SUBSCRIPTION_ID / AZURE_RESOURCE_GROUP /
AZURE_WORKSPACE) — each read into its own field, fixing the reference bug
where all five getenv results are assigned to one variable
(dags/azure_auto_deploy.py:15-19) and the compose bug that sets
workspace = resource group (docker-compose.yml:22)."""

from __future__ import annotations

import os
from dataclasses import dataclass

INSTANCE_TYPE = "Standard_DS2_v2"
BASE_IMAGE = "mcr.microsoft.com/azureml/openmpi4.1.0-ubuntu20.04:latest"


@dataclass
class AzureConfig:
    tenant_id: str
    client_id: str
    client_secret: str
    subscription_id: str
    resource_group: str
    workspace: str

    @classmethod
    def from_env(cls) -> "AzureConfig":
        vals = {}
        for field_name, env in (
            ("tenant_id", "AZURE_TENANT_ID"),
            ("client_id", "AZURE_CLIENT_ID"),
            ("client_secret", "AZURE_CLIENT_SECRET"),
            ("subscription_id", "AZURE_SUBSCRIPTION_ID"),
            ("resource_group", "AZURE_RESOURCE_GROUP"),
            ("workspace", "AZURE_WORKSPACE"),
        ):
            v = os.environ.get(env)
            if not v:
                raise EnvironmentError(f"Missing required env var {env}")
            vals[field_name] = v
        return cls(**vals)


class AzureEndpointClient:
    """EndpointClient over azure-ai-ml (present on Airflow images, see the
    reference Dockerfile:15-19; not required in this repo)."""

    def __init__(self, cfg: AzureConfig | None = None):
        from azure.ai.ml import MLClient
        from azure.identity import ClientSecretCredential

        cfg = cfg or AzureConfig.from_env()
        self.cfg = cfg
        cred = ClientSecretCredential(
            tenant_id=cfg.tenant_id,
            client_id=cfg.client_id,
            client_secret=cfg.client_secret,
        )
        self.ml = MLClient(cred, cfg.subscription_id, cfg.resource_group, cfg.workspace)

    # -- control plane -------------------------------------------------
    def endpoint_exists(self, endpoint: str) -> bool:
        try:
            self.ml.online_endpoints.get(endpoint)
            return True
        except Exception:
            return False

    def create_endpoint(self, endpoint: str) -> None:
        from azure.ai.ml.entities import ManagedOnlineEndpoint

        ep = ManagedOnlineEndpoint(name=endpoint, auth_mode="key")
        self.ml.online_endpoints.begin_create_or_update(ep).result()

    def delete_endpoint(self, endpoint: str) -> None:
        self.ml.online_endpoints.begin_delete(endpoint).result()

    def provisioning_state(self, endpoint: str) -> str:
        return self.ml.online_endpoints.get(endpoint).provisioning_state or ""

    def get_traffic(self, endpoint: str) -> dict:
        return dict(self.ml.online_endpoints.get(endpoint).traffic or {})

    def set_traffic(self, endpoint: str, traffic: dict) -> None:
        ep = self.ml.online_endpoints.get(endpoint)
        ep.traffic = dict(traffic)
        self.ml.online_endpoints.begin_create_or_update(ep).result()

    def get_mirror_traffic(self, endpoint: str) -> dict:
        return dict(self.ml.online_endpoints.get(endpoint).mirror_traffic or {})

    def set_mirror_traffic(self, endpoint: str, traffic: dict) -> None:
        ep = self.ml.online_endpoints.get(endpoint)
        ep.mirror_traffic = dict(traffic)
        self.ml.online_endpoints.begin_create_or_update(ep).result()

    def deploy(self, endpoint: str, slot: str, package_dir: str) -> None:
        from azure.ai.ml.entities import (
            CodeConfiguration,
            Environment,
            ManagedOnlineDeployment,
            Model,
        )

        deployment = ManagedOnlineDeployment(
            name=slot,
            endpoint_name=endpoint,
            model=Model(path=package_dir),
            code_configuration=CodeConfiguration(
                code=package_dir, scoring_script="score.py"
            ),
            environment=Environment(
                conda_file=os.path.join(package_dir, "conda.yaml"),
                image=BASE_IMAGE,
            ),
            instance_type=INSTANCE_TYPE,
            instance_count=1,
        )
        self.ml.online_deployments.begin_create_or_update(deployment).result()

    def delete_deployment(self, endpoint: str, slot: str) -> None:
        self.ml.online_deployments.begin_delete(
            name=slot, endpoint_name=endpoint
        ).result()

    def list_deployments(self, endpoint: str) -> list[str]:
        return [
            d.name for d in self.ml.online_deployments.list(endpoint_name=endpoint)
        ]
